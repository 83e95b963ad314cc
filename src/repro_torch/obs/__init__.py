"""Observability for the port: the span tracer of :mod:`.trace` and the
engine counters of :mod:`.counters`.

Typical use::

    from repro_torch import obs

    with obs.tracing() as tracer:
        ...  # any instrumented work
    tracer.write("trace.json")  # open in ui.perfetto.dev
"""
from __future__ import annotations

from . import counters, trace
from .counters import C, Counters
from .trace import (TRACER, Tracer, chrome_trace, enabled, instant, span,
                    tracing, validate_chrome_trace, write_chrome_trace)

__all__ = ["C", "Counters", "TRACER", "Tracer", "chrome_trace", "counters",
           "enabled", "instant", "span", "trace", "tracing",
           "validate_chrome_trace", "write_chrome_trace"]
