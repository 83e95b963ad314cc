"""Span tracer with Chrome/Perfetto ``trace_event`` export.

The port's copy of ``repro.obs.trace``.  Stdlib only (``torch`` is
imported by the opt-in annotation bridge alone) and built around a
**no-op fast path**: when tracing is disabled, :func:`span` returns a shared do-nothing context
manager — one attribute read and one identity return, no allocation — so
instrumentation can stay inline in hot code.  Enable it for a region with
:func:`tracing`::

    from repro_torch import obs

    with obs.tracing() as tracer:
        planner.plan_host(frames, P=32, m=1024)
    tracer.write("trace.json")   # load in ui.perfetto.dev / chrome://tracing

Events are Chrome ``trace_event`` complete events (``"ph": "X"``) with
microsecond ``ts``/``dur`` relative to the tracer's epoch, plus optional
instant events (:func:`instant`) for point-in-time markers such as replan
decisions.  ``tracing(torch_annotations=True)`` additionally opens a
``torch.profiler.record_function`` range per span so the same names appear
inside a ``torch.profiler`` trace beside the device kernels; the bridge is
opt-in.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["Tracer", "TRACER", "span", "instant", "enabled", "tracing",
           "chrome_trace", "write_chrome_trace", "validate_chrome_trace"]


class _NoopSpan:
    """The disabled path: enter/exit do nothing, ``args`` writes vanish."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def args(self) -> dict:
        return {}  # fresh throwaway dict: callers may assign into it


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        if self._tracer.torch_annotations:
            import torch.profiler
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr = self._tracer
        ev = {"name": self.name, "ph": "X", "pid": tr.pid,
              "tid": threading.get_ident() & 0xFFFF,
              "ts": (self._t0 - tr.epoch_ns) / 1e3,
              "dur": (t1 - self._t0) / 1e3}
        if self.args:
            ev["args"] = self.args
        tr._events.append(ev)
        return False


class Tracer:
    """Event sink + enable flag.  One module-level instance serves the
    whole process (:data:`TRACER`); nesting :func:`tracing` blocks is
    legal and restores the previous state on exit."""

    def __init__(self):
        self.enabled = False
        self.torch_annotations = False
        self.pid = os.getpid()
        self.epoch_ns = time.perf_counter_ns()
        self._events: list[dict] = []

    def span(self, name: str, **args) -> "_Span | _NoopSpan":
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Point-in-time marker (Chrome instant event, thread scope)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self.pid,
              "tid": threading.get_ident() & 0xFFFF,
              "ts": (time.perf_counter_ns() - self.epoch_ns) / 1e3}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def clear(self) -> None:
        self._events = []
        self.epoch_ns = time.perf_counter_ns()

    def events(self) -> list[dict]:
        """Copy of the recorded events (Chrome trace_event dicts)."""
        return list(self._events)

    def chrome_trace(self, **metadata) -> dict:
        return chrome_trace(self._events, **metadata)

    def write(self, path: str, **metadata) -> None:
        write_chrome_trace(path, self._events, **metadata)


#: The process-wide tracer every instrumented module goes through.
TRACER = Tracer()


def span(name: str, **args):
    """A span context manager on the global tracer (no-op when disabled)."""
    t = TRACER
    if not t.enabled:
        return _NOOP
    return _Span(t, name, args)


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)


def enabled() -> bool:
    return TRACER.enabled


@contextlib.contextmanager
def tracing(*, clear: bool = True, torch_annotations: bool = False):
    """Enable the global tracer for a ``with`` block; yields the tracer.

    ``clear`` (default) drops previously recorded events and re-bases the
    epoch so ``ts`` starts near 0; pass ``clear=False`` to append to an
    outer recording.  Prior enabled/bridge state is restored on exit, so
    nesting composes.
    """
    t = TRACER
    prev = (t.enabled, t.torch_annotations)
    if clear:
        t.clear()
    t.enabled = True
    t.torch_annotations = torch_annotations
    try:
        yield t
    finally:
        t.enabled, t.torch_annotations = prev


# ---------------------------------------------------------------------------
# Chrome trace_event JSON


def chrome_trace(events, **metadata) -> dict:
    """Wrap events in the Chrome trace_event 'JSON object' container."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms",
            "otherData": dict(metadata)}


def _coerce(o):
    """json.dump fallback: numpy scalars (anything with .item()) -> python."""
    item = getattr(o, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"not JSON-serializable: {type(o)}")


def write_chrome_trace(path: str, events, **metadata) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events, **metadata), f, indent=1,
                  default=_coerce)


_PHASES = frozenset("XBEiIMCbensfNOD")


def validate_chrome_trace(obj) -> list[dict]:
    """Structural check against the trace_event format; returns the events.

    Accepts both legal top-level forms (the ``{"traceEvents": [...]}``
    object and the bare event array) and raises ``ValueError`` naming the
    first malformed event: every event needs a string ``name``, a known
    ``ph``, numeric ``pid``/``tid``, and a numeric non-negative ``ts``
    (metadata ``ph == "M"`` events are exempt from ``ts``); complete
    events (``ph == "X"``) additionally need a numeric non-negative
    ``dur``; ``args``, when present, must be a dict.  The whole object
    must be JSON-serializable.
    """
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace object has no 'traceEvents' list")
    elif isinstance(obj, list):
        events = obj
    else:
        raise ValueError(f"not a chrome trace: top level is {type(obj)}")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{where}: missing string 'name'")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"{where} ({ev['name']!r}): bad ph {ph!r}")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), (int, float)):
                raise ValueError(f"{where} ({ev['name']!r}): missing {k}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{where} ({ev['name']!r}): bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where} ({ev['name']!r}): "
                                 f"bad dur {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"{where} ({ev['name']!r}): args not a dict")
    json.dumps(obj)  # must round-trip: numpy scalars etc. are bugs here
    return events
