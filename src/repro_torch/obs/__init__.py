"""Observability for the port: the span tracer of :mod:`.trace`, the
engine counters of :mod:`.counters`, :class:`PartitionReport`
(:mod:`.report`), the explain-plan ``registry.explain`` returns, and
:class:`LogHistogram` (:mod:`.hist`), the bounded-memory latency
histogram the serve simulator streams into.

Typical use::

    from repro_torch import obs
    from repro_torch.core import registry

    report = registry.explain("jag-pq-opt", gamma, 1000, P=25, Q=40)
    print(report.summary())

    with obs.tracing() as tracer:
        ...  # any instrumented work
    tracer.write("trace.json")  # open in ui.perfetto.dev
"""
from __future__ import annotations

from . import counters, hist, report, trace
from .counters import C, Counters
from .hist import LogHistogram
from .report import PartitionReport
from .trace import (TRACER, Tracer, chrome_trace, enabled, instant, span,
                    tracing, validate_chrome_trace, write_chrome_trace)

__all__ = ["C", "Counters", "LogHistogram", "PartitionReport", "TRACER",
           "Tracer", "chrome_trace", "counters", "enabled", "hist",
           "instant", "report", "span", "trace", "tracing",
           "validate_chrome_trace", "write_chrome_trace"]
