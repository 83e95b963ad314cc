"""Observability for the port: the span tracer of :mod:`.trace`.

Typical use::

    from repro_torch import obs

    with obs.tracing() as tracer:
        ...  # any instrumented work
    tracer.write("trace.json")  # open in ui.perfetto.dev
"""
from __future__ import annotations

from . import trace
from .trace import (TRACER, Tracer, chrome_trace, enabled, instant, span,
                    tracing, validate_chrome_trace, write_chrome_trace)

__all__ = ["TRACER", "Tracer", "chrome_trace", "enabled", "instant", "span",
           "trace", "tracing", "validate_chrome_trace", "write_chrome_trace"]
