"""Partition-balanced request batcher (the paper's 1D machinery, serving).

Requests arrive with heterogeneous prompt lengths; assigning them naively
round-robin to data-parallel replicas leaves some replicas idle while one
grinds through the long prompts (a straggler). We treat the per-request
token counts as a 1D load array and partition request *ranges* across
replicas with DirectCut (fast path) or the optimal probe-bisection
(quality path) — exactly the paper's DC / NicolPlus trade-off, applied to
inference scheduling. Sorting by length first makes contiguous ranges
meaningful and tightens the bound (documented deviation: the paper's model
has a fixed order; a scheduler may reorder).

The port's NumPy copy of ``repro.serve.batcher``: the same plans on the
same requests.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core import oned, search
from repro_torch.obs import trace as _trace
from repro_torch.obs.counters import C as _C


@dataclasses.dataclass
class Request:
    rid: int
    prompt_tokens: int


@dataclasses.dataclass
class Assignment:
    replica: int
    requests: list[Request]

    @property
    def load(self) -> int:
        return sum(r.prompt_tokens for r in self.requests)


def _direct_cut_speeds(p: np.ndarray, sp: np.ndarray) -> np.ndarray:
    """Capacity-proportional DirectCut: replica i's range ends where the
    token prefix crosses its share of ``total * sp[:i+1].sum() / sp.sum()``
    (dead replicas get empty ranges)."""
    total = float(p[-1])
    targets = total * np.cumsum(sp[:-1]) / float(sp.sum())
    inner = np.searchsorted(p, targets, side="left")
    cuts = np.concatenate([[0], inner, [len(p) - 1]])
    return np.maximum.accumulate(cuts).astype(np.int64)


def plan(requests: list[Request], n_replicas: int, *,
         algo: str = "optimal", sort: bool = True,
         warm: float | None = None, speeds=None) -> list[Assignment]:
    """Partition requests into per-replica groups minimizing the max load.

    ``warm`` seeds the optimal path's bisection with a bottleneck from a
    prior plan (see :func:`replan`); it never changes the resulting cuts.

    ``speeds`` is an optional per-replica capacity vector (mixed
    hardware, or measured progress rates under straggling): the optimal
    path minimizes the *relative* bottleneck ``tokens_i / speeds[i]``
    via the shared capacity-aware engine, the direct path cuts
    capacity-proportional ranges, and dead (``speed=0``) replicas
    receive no requests.  ``rb`` has no capacity-aware form and raises.
    """
    _C.serve_plans += 1
    if len(requests) > _C.serve_queue_peak:
        _C.serve_queue_peak = len(requests)
    with _trace.span("serve.plan", algo=algo, queue_depth=len(requests),
                     replicas=n_replicas):
        sp = search.normalize_speeds(speeds, n_replicas)
        reqs = sorted(requests, key=lambda r: r.prompt_tokens,
                      reverse=True) if sort else list(requests)
        loads = np.array([r.prompt_tokens for r in reqs], dtype=np.int64)
        p = np.concatenate([[0], np.cumsum(loads)])
        if algo == "direct":
            cuts = oned.direct_cut(p, n_replicas) if sp is None \
                else _direct_cut_speeds(p, sp)
        elif algo == "rb":
            if sp is not None:
                raise ValueError("algo='rb' has no capacity-aware form; "
                                 "use 'optimal' or 'direct' with speeds")
            cuts = oned.recursive_bisection(p, n_replicas)
        else:
            cuts = oned.optimal_1d(p, n_replicas, warm=warm, speeds=sp)
        out = []
        for i in range(n_replicas):
            out.append(Assignment(i, reqs[int(cuts[i]):int(cuts[i + 1])]))
        return out


def _greedy_extend(assignments: list[Assignment],
                   new_requests: list[Request],
                   speeds=None) -> list[Assignment]:
    """Keep-path plan: queued requests stay put (zero migration); arrivals
    go LPT-greedy onto the least (relatively) loaded replica.

    A heap keyed on load replaces the linear min-scan per arrival
    (O(K log R) instead of O(K * R)); ``(load, index)`` entries pop the
    lowest index among equal loads, which is exactly the index the scan's
    ``min(..., key=loads.__getitem__)`` picked, so assignments are
    identical — ties included (property-tested on tie-free inputs).

    ``speeds`` ranks replicas by *relative* load ``load / speed`` and
    excludes dead (``speed=0``) replicas from receiving arrivals.
    """
    sp = search.normalize_speeds(speeds, len(assignments))
    out = [Assignment(a.replica, list(a.requests)) for a in assignments]
    heap = [(a.load / (1.0 if sp is None else sp[i]), i)
            for i, a in enumerate(out) if sp is None or sp[i] > 0]
    heapq.heapify(heap)
    for r in sorted(new_requests, key=lambda r: r.prompt_tokens,
                    reverse=True):
        load, i = heapq.heappop(heap)
        out[i].requests.append(r)
        heapq.heappush(
            heap,
            (load + r.prompt_tokens / (1.0 if sp is None else sp[i]), i))
    return out


def _max_rel_load(assignments: list[Assignment], sp) -> float:
    """Bottleneck of an assignment list: absolute max load, or max
    relative load ``load_i / speeds_i`` under a speed vector (a *loaded*
    dead replica reads as ``inf`` — the invalid-plan signal)."""
    loads = np.array([float(a.load) for a in assignments])
    if not loads.size:
        return 0.0
    if sp is None:
        return float(loads.max())
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(loads > 0, loads / sp, 0.0)
    return float(rel.max())


def replan(assignments: list[Assignment], new_requests: list[Request], *,
           algo: str = "optimal", sort: bool = True, policy=None,
           alpha: float = 0.0, replan_overhead: float = 0.0,
           steps_since_replan: int = 1,
           last_migration_volume: float = 0.0, speeds=None):
    """Re-partition queued + newly arrived requests, warm-starting from the
    prior plan.

    The previous assignment's bottleneck (max replica load) seeds the
    bisection (``oned.probe_bisect_optimal(warm=...)``): one probe turns it
    into a tightened upper or lower bound, so the search only resolves the
    load drift the arrivals introduced instead of the full DirectCut
    interval.  Equivalent cuts to ``plan()`` from scratch — the warm start
    changes probe count, never the optimum.

    Always returns ``(assignments, mode)`` with ``mode`` in
    ``{'keep', 'fast', 'slow'}``.  ``policy=None`` (default)
    re-partitions unconditionally with ``algo`` (mode reports the effort
    spent: ``'slow'`` for the optimal bisection, ``'fast'`` for the
    DirectCut-family paths).  With a policy the replan is *graded*
    through the planner API's shared decision point
    (:func:`repro_torch.rebalance.policy.replan_mode`): the cheap
    keep-path appends
    arrivals LPT-greedy to the least-loaded replicas (queued requests
    never change replica — no KV migration); ``'fast'`` buys the
    DirectCut re-partition (always DirectCut — it doubles as the
    predictor of the fresh-plan bottleneck, so it must stay the cheap
    path); ``'slow'`` escalates to the caller's ``algo``, warm-seeded by
    the fast candidate's bottleneck when it is the optimal bisection.

    ``speeds`` pins the capacity-aware semantics end-to-end: *every*
    grade honors capacities — the
    keep-path extends LPT on relative load (dead replicas receive no
    arrivals), the fast predictor cuts capacity-proportional ranges via
    ``_direct_cut_speeds`` rather than ignoring speeds, the slow path
    runs the capacity-aware bisection, and the policy's ``StepState``
    compares *relative* bottlenecks against the capacity-weighted ideal
    ``total / speeds.sum()`` so the grading itself is speed-consistent.
    """
    if not assignments:
        raise ValueError("replan needs at least one existing assignment "
                         "(the replica count comes from the prior plan)")
    R = len(assignments)
    sp = search.normalize_speeds(speeds, R)
    reqs = [r for a in assignments for r in a.requests] + list(new_requests)
    warm = _max_rel_load(assignments, sp)
    _C.serve_replans += 1
    if len(reqs) > _C.serve_queue_peak:
        _C.serve_queue_peak = len(reqs)
    with _trace.span("serve.replan", queue_depth=len(reqs),
                     arrivals=len(new_requests),
                     replicas=R) as sp_:
        if policy is None:
            mode = "slow" if algo == "optimal" else "fast"
            sp_.args["mode"] = mode
            warm = warm if warm > 0 and np.isfinite(warm) else None
            return plan(reqs, R, algo=algo, sort=sort,
                        warm=warm, speeds=speeds), mode

        from repro_torch.rebalance.policy import StepState, replan_mode
        total = float(sum(r.prompt_tokens for r in reqs))
        ext = _greedy_extend(assignments, new_requests, speeds=speeds)
        ext_load = _max_rel_load(ext, sp)
        fast = plan(reqs, R, algo="direct", sort=sort, speeds=speeds)
        fast_load = _max_rel_load(fast, sp)
        ideal = total / (R if sp is None else float(sp.sum()))
        state = StepState(step=steps_since_replan, max_load=ext_load,
                          ideal=ideal, total_load=total,
                          achieved_at_replan=fast_load, total_at_replan=total,
                          steps_since_replan=steps_since_replan,
                          last_migration_volume=last_migration_volume,
                          alpha=alpha, replan_overhead=replan_overhead)
        mode = replan_mode(policy, state)
        sp_.args["mode"] = mode
        if mode == "keep":
            return ext, mode
        if mode == "slow":
            warm = fast_load if algo == "optimal" and fast_load > 0 \
                and np.isfinite(fast_load) else None
            return plan(reqs, R, algo=algo, sort=sort, warm=warm,
                        speeds=speeds), mode
        return fast, mode


def imbalance(assignments: list[Assignment]) -> float:
    """Relative load imbalance ``max/avg - 1`` (0.0 when it is undefined:
    no replicas, or an all-empty queue — the explicit guard keeps the
    empty list from ever reaching ``max()``)."""
    loads = [a.load for a in assignments]
    if not loads:
        return 0.0
    avg = sum(loads) / len(loads)
    return max(loads) / avg - 1.0 if avg > 0 else 0.0


def replica_loads(assignments: list[Assignment]) -> np.ndarray:
    """Per-replica token loads as an array (the serving load vector)."""
    return np.array([a.load for a in assignments], dtype=np.int64)


def load_histogram(assignments: list[Assignment], bins: int = 10
                   ) -> tuple[np.ndarray, np.ndarray]:
    """``np.histogram`` of per-replica loads — the skew view a dashboard
    wants: a balanced plan is one tall bucket, a straggler a far-right
    outlier.  Returns ``(counts, bin_edges)``."""
    return np.histogram(replica_loads(assignments), bins=bins)


def straggler_rebalance(assignments: list[Assignment],
                        progress: list[float], *,
                        speeds=None) -> list[Assignment]:
    """Straggler mitigation: replicas report progress in [0, 1]; remaining
    work is re-partitioned over all replicas via the capacity-aware 1D
    optimal partitioner.

    ``speeds=None`` redistributes equally (the straggler is assumed
    transient).  Passing per-replica capacities — e.g. the measured
    progress rates themselves, when the slowdown is expected to persist —
    gives slow replicas proportionally less of the remaining work and a
    dead (``speed=0``) replica none, so one failed replica no longer
    re-straggles the rebalanced batch.
    """
    if len(progress) != len(assignments):
        # zip would silently truncate — and a short progress list would
        # drop whole replicas' queues from the rebalanced plan
        raise ValueError(
            f"progress has {len(progress)} entries for "
            f"{len(assignments)} replicas; every replica must report")
    remaining: list[Request] = []
    for a, prog in zip(assignments, progress):
        keep = int(len(a.requests) * prog)
        remaining.extend(a.requests[keep:])
    return plan(remaining, len(assignments), speeds=speeds)
