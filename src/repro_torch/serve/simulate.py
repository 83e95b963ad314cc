"""Continuous-batching serve simulator over the array-backed queue.

The closed loop the ROADMAP asks for: requests arrive (Poisson or trace,
streamed in chunks so millions of requests never materialize at once),
are admitted into a :class:`~repro_torch.serve.queue.RequestQueue`, and each
scheduler tick grades a replan through the shared
``rebalance.policy.replan_mode`` decision point:

- ``keep``  — arrivals go LPT onto the least-loaded replicas, queued
  requests never change owner (zero KV migration);
- ``fast``  — capacity-proportional DirectCut over the incremental
  prefix (O(m log n));
- ``slow``  — the exact bisection, warm-seeded by the fast candidate.

Replicas then burn their per-tick token budgets front-to-back through
their contiguous ranges; completion times interpolate inside the tick,
so every request's latency (queue wait + service under its replica's
speed) is accounted end-to-end.  :class:`SimResult` carries exact
p50/p99 from the retained latency chunks plus the bounded-memory
:class:`~repro_torch.obs.hist.LogHistogram` view, sustained throughput, the
graded replan mix, and the serve-side migration ledger (tokens whose
owner changed at adopted replans — the KV bytes a real engine would
move; ``rebalance.execute`` is the device twin of that ledger for the
2D runtime).

The port's NumPy copy of ``repro.serve.simulate``: the same seeded
arrivals give the same run.  It holds nothing on the card.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import search
from repro_torch.obs import trace as _trace
from repro_torch.obs.counters import C as _C
from repro_torch.obs.hist import LogHistogram

from . import queue as squeue

__all__ = ["SimResult", "TickRecord", "poisson_arrivals", "simulate",
           "trace_arrivals"]


def poisson_arrivals(n: int, rate: float, *, seed: int = 0,
                     chunk: int = 65536, pareto_shape: float = 1.8,
                     mean_tokens: float = 256.0, max_tokens: int = 4096):
    """Yield ``(times, tokens)`` chunks: Poisson arrivals at ``rate``
    requests per time unit with heavy-tail (Pareto) prompt lengths.

    Lengths are ``1 + round(Pareto(shape) * scale)`` clipped to
    ``max_tokens``, with ``scale`` chosen so the *unclipped* mean is
    ``mean_tokens`` (shape > 1; heavier tails = smaller shape).
    """
    if rate <= 0 or n < 0:
        raise ValueError(f"need rate > 0 and n >= 0, got {rate}, {n}")
    rng = np.random.default_rng(seed)
    scale = (mean_tokens - 1.0) * (pareto_shape - 1.0)
    t = 0.0
    left = int(n)
    while left > 0:
        k = min(chunk, left)
        times = t + np.cumsum(rng.exponential(1.0 / rate, k))
        t = float(times[-1])
        toks = 1 + np.round(rng.pareto(pareto_shape, k) * scale)
        toks = np.minimum(toks, max_tokens).astype(np.int64)
        yield times, toks
        left -= k


def trace_arrivals(times, tokens, *, chunk: int = 65536):
    """Yield ``(times, tokens)`` chunks from a recorded trace (times must
    be non-decreasing)."""
    times = np.asarray(times, dtype=np.float64).ravel()
    tokens = np.asarray(tokens, dtype=np.int64).ravel()
    if times.size != tokens.size:
        raise ValueError("times and tokens must have equal length")
    if times.size and (np.diff(times) < 0).any():
        raise ValueError("trace times must be non-decreasing")
    for s in range(0, times.size, chunk):
        yield times[s:s + chunk], tokens[s:s + chunk]


class _Feed:
    """Pulls arrival chunks lazily as simulated time advances."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self._t = np.empty(0)
        self._k = np.empty(0, dtype=np.int64)
        self._i = 0
        self.done = False
        self._pull()

    def _pull(self) -> None:
        chunk = next(self._it, None)
        if chunk is None:
            self.done = True
            return
        t, k = chunk
        self._t = np.asarray(t, dtype=np.float64).ravel()
        self._k = np.asarray(k, dtype=np.int64).ravel()
        self._i = 0

    @property
    def exhausted(self) -> bool:
        return self.done and self._i >= self._t.size

    def next_time(self) -> float:
        """Arrival time of the next pending request (inf when drained)."""
        while not self.done and self._i >= self._t.size:
            self._pull()
        return float(self._t[self._i]) if self._i < self._t.size \
            else float("inf")

    def take_until(self, now: float) -> tuple[np.ndarray, np.ndarray]:
        """All arrivals with time < ``now``, across chunk boundaries."""
        ts, ks = [], []
        while True:
            j = int(np.searchsorted(self._t, now, side="left"))
            if j > self._i:
                ts.append(self._t[self._i:j])
                ks.append(self._k[self._i:j])
                self._i = j
            if j < self._t.size or self.done:
                break
            self._pull()
        if not ts:
            return np.empty(0), np.empty(0, dtype=np.int64)
        return np.concatenate(ts), np.concatenate(ks)


@dataclasses.dataclass(frozen=True)
class TickRecord:
    """One scheduler tick of the serve loop (``record_ticks=True``)."""

    tick: int
    now: float
    admitted: int
    completed: int
    evicted: int
    queue_depth: int
    mode: str            # 'keep' | 'fast' | 'slow' | 'idle'
    max_load: float      # adopted plan's (relative) bottleneck
    ideal: float
    migrated_tokens: int  # tokens whose owner changed this tick


@dataclasses.dataclass
class SimResult:
    """Outcome of one :func:`simulate` run."""

    admitted: int
    completed: int
    evicted: int
    ticks: int
    sim_time: float
    wall_time: float
    replans: dict[str, int]          # mode -> count over all ticks
    migrated_tokens: int             # serve-side migration ledger
    hist: LogHistogram               # streaming latency view
    latency_chunks: list = dataclasses.field(default_factory=list,
                                             repr=False)
    tick_records: list | None = None
    queue_peak: int = 0

    def latencies(self) -> np.ndarray:
        return np.concatenate(self.latency_chunks) \
            if self.latency_chunks else np.empty(0)

    def percentile(self, q) -> np.ndarray | float:
        """Exact latency percentile(s) from the retained samples."""
        lat = self.latencies()
        if not lat.size:
            return np.zeros_like(np.asarray(q, dtype=float))[()]
        return np.percentile(lat, q)

    @property
    def throughput(self) -> float:
        """Completed requests per simulated time unit."""
        return self.completed / self.sim_time if self.sim_time > 0 else 0.0

    def summary(self) -> str:
        p50, p99 = (self.percentile([50, 99]) if self.completed
                    else (0.0, 0.0))
        return (f"{self.completed}/{self.admitted} done in "
                f"{self.sim_time:.1f}t ({self.ticks} ticks, "
                f"{self.throughput:.1f} req/t) p50={p50:.3f} "
                f"p99={p99:.3f} replans={self.replans} "
                f"migrated={self.migrated_tokens}")


def _range_rel_max(pf, cuts: np.ndarray, sp) -> float:
    """Max (relative) range load of a cut array, off the prefix structure."""
    best = 0.0
    prev = pf.prefix_tokens(int(cuts[0]))
    for i in range(cuts.size - 1):
        cur = pf.prefix_tokens(int(cuts[i + 1]))
        load = cur - prev
        prev = cur
        if load > 0:
            rel = load / (1.0 if sp is None else sp[i])
            best = max(best, rel)
    return best


def _lpt_preview(q, R: int, sp) -> tuple[np.ndarray, np.ndarray, float]:
    """The keep-path candidate without committing it: LPT labels for the
    unassigned rows, plus the resulting relative bottleneck."""
    import heapq
    loads = q.loads(R)
    heap = [(loads[i] / (1.0 if sp is None else sp[i]), i)
            for i in range(R) if sp is None or sp[i] > 0]
    heapq.heapify(heap)
    idx = np.flatnonzero(q.replica < 0)
    labels = np.empty(idx.size, dtype=np.int64)
    for j, i in enumerate(idx):
        key, r = heapq.heappop(heap)
        labels[j] = r
        heapq.heappush(heap, (key + float(q.rem[i])
                              / (1.0 if sp is None else sp[r]), r))
    # the heap keys are the final relative loads; assigned-only replicas
    # (dead ones excluded from the heap) can still carry load
    rel = {r: key for key, r in heap}
    for i in range(R):
        if i not in rel:
            rel[i] = float("inf") if loads[i] > 0 else 0.0
    return idx, labels, max(rel.values(), default=0.0)


def simulate(arrivals, *, n_replicas: int, speeds=None,
             service_rate: float = 2048.0, tick: float = 1.0,
             policy=None, algo: str = "optimal",
             deadline: float | None = None, max_ticks: int | None = None,
             cap: int = squeue.DEFAULT_CAP, block: int = 512,
             record_ticks: bool = False,
             latency_lo: float = 1e-3, latency_hi: float = 1e5) -> SimResult:
    """Run the continuous-batching loop to completion.

    ``arrivals`` is an iterable of ``(times, tokens)`` chunks
    (:func:`poisson_arrivals` / :func:`trace_arrivals`).  Replica ``r``
    serves ``service_rate * speeds[r] * tick`` tokens per tick
    (``speeds=None`` = uniform 1.0).  ``policy=None`` replans every tick
    with ``algo``; a policy grades each tick keep/fast/slow.  Requests
    older than ``deadline`` are evicted unserved (counted, no latency
    sample).  The loop drains the queue after arrivals end;
    ``max_ticks`` bounds runaway overload runs.
    """
    sp = search.normalize_speeds(speeds, n_replicas)
    budgets = np.maximum(np.floor(
        service_rate * (np.ones(n_replicas) if sp is None else sp)
        * tick), 0).astype(np.int64)
    if budgets.sum() <= 0:
        raise ValueError("per-tick service budgets are all zero; raise "
                         "service_rate * tick")
    q = squeue.RequestQueue(cap=cap, block=block)
    feed = _Feed(arrivals)
    res = SimResult(admitted=0, completed=0, evicted=0, ticks=0,
                    sim_time=0.0, wall_time=0.0,
                    replans={"keep": 0, "fast": 0, "slow": 0, "idle": 0},
                    migrated_tokens=0,
                    hist=LogHistogram(latency_lo, latency_hi),
                    tick_records=[] if record_ticks else None)
    denom = float(n_replicas) if sp is None else float(sp.sum())
    steps_since = 1
    last_mig = 0.0
    t0 = time.perf_counter()
    now = 0.0
    while True:
        if max_ticks is not None and res.ticks >= max_ticks:
            break
        if q.n == 0:
            if feed.exhausted and feed.next_time() == float("inf"):
                break
            nxt = feed.next_time()
            if nxt == float("inf"):
                break
            # fast-forward an idle scheduler to the next arrival's tick
            if nxt >= now + tick:
                now = np.floor(nxt / tick) * tick
        _C.serve_ticks += 1
        res.ticks += 1
        tick_no = res.ticks
        with _trace.span("serve.tick", tick=tick_no) as span_:
            at, toks = feed.take_until(now + 1e-12)
            if toks.size:
                q.admit(toks, arrival_times=at)
                _C.serve_admitted += toks.size
                res.admitted += toks.size
            evicted = 0
            if deadline is not None and q.n:
                stale = np.flatnonzero(now - q.arrival > deadline)
                if stale.size:
                    q.evict_indices(stale)
                    evicted = stale.size
                    res.evicted += evicted
            migrated = done = 0
            mode = "idle"
            max_rel = ideal = 0.0
            if q.n:
                total = float(q.total_remaining)
                ideal = total / denom
                if policy is None:
                    mode = "slow" if algo == "optimal" else "fast"
                    cuts = q.plan_cuts(n_replicas, algo=algo, speeds=sp)
                    old = q.replica.copy()
                    q.assign_contiguous(cuts)
                    migrated = int(q.rem[(old >= 0)
                                         & (old != q.replica)].sum())
                    max_rel = _range_rel_max(q.prefix, cuts, sp)
                else:
                    idx, labels, ext_rel = _lpt_preview(q, n_replicas, sp)
                    fast = squeue.direct_cut(q.prefix, n_replicas,
                                             speeds=sp)
                    fast_rel = _range_rel_max(q.prefix, fast, sp)
                    from repro_torch.rebalance.policy import (StepState,
                                                        replan_mode)
                    state = StepState(
                        step=tick_no, max_load=ext_rel, ideal=ideal,
                        total_load=total, achieved_at_replan=fast_rel,
                        total_at_replan=total,
                        steps_since_replan=steps_since,
                        last_migration_volume=last_mig,
                        alpha=0.0, replan_overhead=0.0)
                    mode = replan_mode(policy, state)
                    _C.serve_replans += 1
                    if mode == "keep":
                        q.replica[idx] = labels
                        max_rel = ext_rel
                        steps_since += 1
                    else:
                        if mode == "slow":
                            warm = fast_rel if fast_rel > 0 else None
                            cuts = q.plan_cuts(n_replicas, algo="optimal",
                                               warm=warm, speeds=sp)
                        else:
                            cuts = fast
                        old = q.replica.copy()
                        q.assign_contiguous(cuts)
                        migrated = int(q.rem[(old >= 0)
                                             & (old != q.replica)].sum())
                        max_rel = _range_rel_max(q.prefix, cuts, sp)
                        last_mig = float(migrated)
                        steps_since = 1
                res.migrated_tokens += migrated
                rids, lats = q.serve(budgets, now=now, dt=tick)
                if rids.size:
                    done = int(rids.size)
                    res.completed += done
                    res.latency_chunks.append(lats)
                    res.hist.add(lats)
            res.replans[mode] += 1
            res.queue_peak = max(res.queue_peak, q.n)
            span_.args.update(mode=mode, admitted=int(toks.size),
                              queue=q.n, evicted=evicted)
            if res.tick_records is not None:
                res.tick_records.append(TickRecord(
                    tick=tick_no, now=now, admitted=int(toks.size),
                    completed=done, evicted=evicted, queue_depth=q.n,
                    mode=mode, max_load=max_rel, ideal=ideal,
                    migrated_tokens=migrated))
        now += tick
        res.sim_time = now
    res.wall_time = time.perf_counter() - t0
    return res
