"""Algorithm registry: name -> partitioner(gamma, m, **kw) -> Partition.

The port of ``repro.core.registry``.  Names follow the paper (Table 1).
Jagged algorithms default to the -BEST orientation variant; append
'-hor'/'-ver' for the fixed-orientation ones.

The host algorithms are the NumPy engine (``rect``, ``jagged``, ``hier``,
``hybrid``, ``threed``), bit-identical to the reference.  The
device-backed names (``jag-pq-opt-device*``, ``jag-m-opt-device*``,
``sgorp-2d``, ``sgorp-3d``) take ``device=None``, which means the card,
and raise ``RuntimeError`` where CUDA is absent; ``device="cpu"`` runs
their plain versions on the CPU.
"""
from __future__ import annotations

import functools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.obs import counters as _counters
from repro_torch.obs import trace as _trace
from repro_torch.obs.report import PartitionReport

from . import device as _device
from . import hier, hybrid, jagged, rect, search, sgorp, threed
from .types import Partition

_REGISTRY: dict[str, Callable[..., Partition]] = {}

# Algorithms that accept a heterogeneous per-processor ``speeds`` vector
# (relative-load objective; dead speed=0 parts get zero-width rects —
# except the sgorp family, whose fixed rectilinear grid cannot collapse
# a cell: it raises on any non-positive speed).
# Uniform/None speeds are legal everywhere — they normalize away before
# dispatch, so every algorithm stays bit-identical to its homogeneous self.
CAPACITY_AWARE = frozenset(
    {"jag-pq-heur", "jag-pq-opt", "jag-pq-opt-device", "jag-m-heur",
     "jag-m-heur-probe"}
    | {f"{_n}-{_o}"
       for _n in ("jag-pq-heur", "jag-pq-opt", "jag-pq-opt-device",
                  "jag-m-heur", "jag-m-heur-probe")
       for _o in ("hor", "ver")}
    | {"hybrid", "hybrid_auto", "hybrid-auto", "hybrid_fastslow",
       "hybrid-fastslow"}
    | {"sgorp-2d", "sgorp-3d", "jag-m-heur-3d"})

# Rank-3 algorithms consume the RAW (n1, n2, n3) load volume, not a
# prefix — building (and sharing) the 3D prefix is the algorithm's own
# concern (one prefix serves slab solves, loads and validity checks).
# They return :class:`repro_torch.core.threed.Partition3D`.
RANK3 = frozenset({"jag-m-heur-3d", "sgorp-3d", "project-then-2d"})


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> Callable[..., Partition]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def partition(name: str, gamma: np.ndarray, m: int, *,
              speeds=None, **kw) -> Partition:
    fn = get(name)
    nd = np.ndim(gamma)
    if nd == 3 and name not in RANK3:
        raise ValueError(
            f"{name!r} is a 2D algorithm but the input is rank-3; "
            f"rank-3 (raw load volume) algorithms: {sorted(RANK3)}")
    if nd == 2 and name in RANK3:
        raise ValueError(
            f"{name!r} expects a raw (n1, n2, n3) load volume, got a "
            f"rank-2 input (2D algorithms take a Gamma prefix)")
    _counters.C.reset()  # counter state is per-partition-call (see obs)
    sp = search.normalize_speeds(speeds, m) if speeds is not None else None
    with _trace.span(f"partition.{name}", m=int(m)):
        if sp is None:
            p = fn(gamma, m, **kw)
        elif name in CAPACITY_AWARE:
            p = fn(gamma, m, speeds=sp, **kw)
        else:
            raise ValueError(
                f"{name!r} does not support heterogeneous speeds; "
                f"capacity-aware algorithms: {sorted(CAPACITY_AWARE)}")
    if p.m_target is None:
        p.m_target = m
    return p


def explain(name: str, gamma: np.ndarray, m: int, *, speeds=None,
            **kw) -> PartitionReport:
    """Partition with tracing on and return the structured explain-plan.

    Runs :func:`partition` under :func:`repro_torch.obs.tracing` and
    packages the result as a :class:`~repro_torch.obs.report.
    PartitionReport`: the partition (bit-identical to the plain call —
    only the probe *timing* is observed, never the verdicts), its
    bottleneck / ideal / imbalance, the per-phase spans, and the engine
    counter snapshot.  Composes with an enclosing ``obs.tracing()`` block:
    the outer recording keeps its events and gains this call's spans.

    ``bottleneck`` / ``ideal`` are raw load values even under
    heterogeneous ``speeds`` (the relative-load view depends on the
    consumer's speed semantics; the partition object supports both).
    """
    gamma = np.asarray(gamma)
    nested = _trace.enabled()
    with _trace.tracing(clear=not nested) as tr:
        before = len(tr._events)
        t0 = time.perf_counter()
        part = partition(name, gamma, m, speeds=speeds, **kw)
        wall = time.perf_counter() - t0
        snap = _counters.C.snapshot()
        spans = tr.events()[before:]
    if gamma.ndim == 3:
        # rank-3 names take the raw load volume (see RANK3): shape is the
        # volume itself and the bottleneck comes from the 3D prefix gather
        bottleneck = float(part.max_load(gamma))
        total = float(gamma.sum())
        shape = tuple(gamma.shape)
    else:
        bottleneck = float(part.max_load(gamma))
        total = float(gamma[-1, -1])
        shape = (gamma.shape[0] - 1, gamma.shape[1] - 1)
    ideal = total / m if m else 0.0
    imbalance = bottleneck / ideal - 1.0 if ideal > 0 else 0.0
    return PartitionReport(
        algo=name, m=int(m), shape=shape,
        bottleneck=bottleneck, ideal=ideal, imbalance=imbalance,
        wall_time=wall, partition=part, spans=spans, counters=snap)


_REGISTRY["rect-uniform"] = rect.rect_uniform
_REGISTRY["rect-nicol"] = rect.rect_nicol

for _name, _fn in [("jag-pq-heur", jagged.jag_pq_heur),
                   ("jag-pq-opt", jagged.jag_pq_opt),
                   ("jag-m-heur", jagged.jag_m_heur),
                   ("jag-m-heur-probe", jagged.jag_m_heur_probe),
                   ("jag-m-alloc", jagged.jag_m_alloc),
                   ("jag-m-opt", jagged.jag_m_opt)]:
    _REGISTRY[_name] = _fn
    for _o in ("hor", "ver"):
        _REGISTRY[f"{_name}-{_o}"] = functools.partial(_fn, orient=_o)

for _v in ("load", "dist", "hor", "ver"):
    _REGISTRY[f"hier-rb-{_v}"] = functools.partial(hier.hier_rb, variant=_v)
    _REGISTRY[f"hier-relaxed-{_v}"] = functools.partial(
        hier.hier_relaxed, variant=_v)
_REGISTRY["hier-rb"] = functools.partial(hier.hier_rb, variant="load")
_REGISTRY["hier-relaxed"] = functools.partial(hier.hier_relaxed,
                                              variant="load")
_REGISTRY["hier-opt"] = hier.hier_opt


@register("hybrid")
def _hybrid_default(gamma, m, P: int | None = None, **kw):
    """Engine-native HYBRID (phase 1 JAG-M-HEUR, fast phase 2
    JAG-M-HEUR-PROBE, slow refinement JAG-M-OPT) — the paper's
    best-performing configuration on the shared probe state."""
    return hybrid.hybrid(gamma, m, P=P, **kw)


@register("hybrid_auto")
def _hybrid_auto(gamma, m, **kw):
    """HYBRID with P from the expected-LI scan (paper Figure 16)."""
    return hybrid.hybrid_auto(gamma, m, **kw)


@register("hybrid_fastslow")
def _hybrid_fastslow(gamma, m, P: int | None = None, **kw):
    """HYBRID's time/quality knob: exhaustive fast/slow refinement."""
    return hybrid.hybrid_fastslow(gamma, m, P=P, **kw)


# dash-style aliases matching the rest of the registry's naming
_REGISTRY["hybrid-auto"] = _REGISTRY["hybrid_auto"]
_REGISTRY["hybrid-fastslow"] = _REGISTRY["hybrid_fastslow"]


# ---------------------------------------------------------------------------
# device-native exact variants (``core.device``), on ``device`` (None: the
# card)


def _resolve(device) -> torch.device:
    from repro_torch.rebalance.planner import resolve_device
    return resolve_device(device)


def _as_device_gamma(gamma, dev: torch.device) -> torch.Tensor:
    """The Gamma as the device solvers take it: int32 for integer loads,
    float32 otherwise (the reference's dtypes with JAX's x64 off).  Totals
    of 2**31 and above are refused here, as in the reference; the solvers
    themselves refuse int32 totals from 2**30 (the greedy targets ``p +
    L`` must stay inside int32)."""
    g = np.asarray(gamma)
    if np.issubdtype(g.dtype, np.integer):
        if int(g[-1, -1]) >= 2 ** 31:
            raise ValueError(
                f"total load {int(g[-1, -1])} overflows the device "
                f"solvers' int32 accumulators; use the host solver or "
                f"pass a float gamma")
        return torch.as_tensor(g.astype(np.int32), device=dev)
    return torch.as_tensor(g.astype(np.float32), device=dev)


@jagged._with_orientation
def _jag_pq_opt_device(gamma, m, P: int | None = None,
                       Q: int | None = None, speeds=None,
                       device=None) -> Partition:
    """Registry adapter: exact P x Q jagged, bisection fully on device.

    Same contract (and bit-identical cuts on integer loads) as
    ``jag-pq-opt``; the device round-trips only the O(P * Q) cut vectors.
    """
    dev = _resolve(device)
    if P is None or Q is None:
        P, Q = jagged._default_pq(m)
    sp = None if speeds is None else torch.as_tensor(
        np.asarray(speeds, np.float32), device=dev)
    rc, _, cc, _ = _device.jag_pq_opt_device_impl(
        _as_device_gamma(gamma, dev), P=P, Q=Q, speeds=sp)
    cc = cc.cpu().numpy()
    return jagged._build(gamma, rc.cpu().numpy(), [cc[s] for s in range(P)])


@jagged._with_orientation
def _jag_m_opt_device(gamma, m, device=None) -> Partition:
    """Registry adapter: exact m-way jagged DP, bisection on device.

    Bottleneck bit-identical to ``jag-m-opt``; the realized stripe
    structure may differ among equally-optimal decompositions.
    """
    dev = _resolve(device)
    rc, cnt, cc, ns, _ = _device.jag_m_opt_device_impl(
        _as_device_gamma(gamma, dev), m=m)
    ns = int(ns)
    cnt = cnt.cpu().numpy()
    cc = cc.cpu().numpy()
    return jagged._build(gamma, rc.cpu().numpy()[:ns + 1],
                         [cc[s][:cnt[s] + 1] for s in range(ns)])


for _name, _fn in [("jag-pq-opt-device", _jag_pq_opt_device),
                   ("jag-m-opt-device", _jag_m_opt_device)]:
    _REGISTRY[_name] = _fn
    for _o in ("hor", "ver"):
        _REGISTRY[f"{_name}-{_o}"] = functools.partial(_fn, orient=_o)


# ---------------------------------------------------------------------------
# d-dimensional family.  The 3D entries take the raw load volume (RANK3
# above).


@register("sgorp-2d")
def _sgorp_2d(gamma, m, **kw) -> Partition:
    """Device SGORP rectilinear refiner on a 2D Gamma (never worse than
    its per-axis 1D projection warm start)."""
    return sgorp.sgorp_2d(gamma, m, **kw)


@register("sgorp-3d")
def _sgorp_3d(A, m, **kw):
    """Device SGORP rectilinear refiner on a raw (n1, n2, n3) volume."""
    return sgorp.sgorp_3d(A, m, **kw)


_REGISTRY["jag-m-heur-3d"] = threed.jag_m_heur_3d
_REGISTRY["project-then-2d"] = threed.project_then_2d
