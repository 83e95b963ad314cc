"""One-dimensional partitioning algorithms (paper Section 2.2).

The port's NumPy copy of ``repro.core.oned``: the same code in the same
order of floating-point operations, so its results are bit-identical.

All functions operate on an *exclusive prefix-sum array* ``p`` of length
``n+1`` (``p[0] == 0``, ``p[i] == a[:i].sum()``), so the load of interval
``[b, e)`` is ``p[e] - p[b]``. A partition into ``m`` intervals is returned
as a non-decreasing cut array of length ``m+1`` with ``cuts[0] == 0`` and
``cuts[m] == n``. Empty intervals are allowed.

Algorithms:

- ``direct_cut``      -- DC / "Heuristic 1" of Miguet-Pierson; 2-approx,
                         ``Lmax <= sum/m + max``.
- ``recursive_bisection`` -- RB; same bound, O(m log n).
- ``dp_optimal``      -- Manne-Olstad dynamic program (exact), with binary
                         search over the bi-monotonic inner objective.
- ``probe``           -- Han-Narahari-Choi greedy feasibility test for a
                         target bottleneck L, O(m log n).
- ``nicol_optimal``   -- exact bottleneck via Nicol's parametric search over
                         realizable interval sums, with Pinar-Aykanat style
                         bound tightening (the "NicolPlus" engineering).
- ``probe_bisect_optimal`` -- exact-for-integer-loads bisection on L with
                         ``probe``, driven by the shared wide-bisection
                         engine in :mod:`repro_torch.core.search`.
- ``optimal_1d_batch`` -- many independent (prefix array, m) problems solved
                         in lockstep through one packed multi-chain probe.
- ``probe_multi`` / ``nicol_multi`` -- PROBE-M and the multi-array optimal
                         partitioner (paper Section 3.2.2), the engine of
                         JAG-M-PROBE.

The bisection-on-L loops that used to live here are gone; feasibility
verdicts and realized cuts are unchanged (``search`` is exact), so all
bottlenecks are bit-identical to the seed implementations.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.counters import C as _C

from . import search

__all__ = [
    "direct_cut", "recursive_bisection", "dp_optimal", "probe",
    "probe_count", "nicol_optimal", "probe_bisect_optimal", "optimal_1d",
    "optimal_1d_batch", "probe_multi", "nicol_multi", "cuts_to_intervals",
    "max_interval_load",
]


def cuts_to_intervals(cuts: np.ndarray) -> list[tuple[int, int]]:
    return [(int(cuts[i]), int(cuts[i + 1])) for i in range(len(cuts) - 1)]


def max_interval_load(p: np.ndarray, cuts: np.ndarray) -> float:
    cuts = np.asarray(cuts)
    return float((p[cuts[1:]] - p[cuts[:-1]]).max(initial=0))


# ---------------------------------------------------------------------------
# Heuristics


def direct_cut(p: np.ndarray, m: int) -> np.ndarray:
    """Greedy: each processor takes the smallest interval with load >= avg.

    Vectorized form: cut i is the first index where p >= i * total / m,
    which is exactly the greedy since p is non-decreasing.
    """
    n = len(p) - 1
    total = p[-1]
    targets = total / m * np.arange(1, m, dtype=np.float64)
    cuts = np.empty(m + 1, dtype=np.int64)
    cuts[0], cuts[m] = 0, n
    cuts[1:m] = np.searchsorted(p, targets, side="left")
    # monotonicity is automatic; clip to stay within [0, n]
    np.clip(cuts, 0, n, out=cuts)
    return cuts


def recursive_bisection(p: np.ndarray, m: int) -> np.ndarray:
    """RB: split into ~equal halves of load, recurse with m//2 / m - m//2."""
    n = len(p) - 1
    cuts = [0] * (m + 1)
    cuts[m] = n

    def rec(b: int, e: int, lo_proc: int, hi_proc: int) -> None:
        k = hi_proc - lo_proc
        if k <= 1 or e <= b:
            for t in range(lo_proc + 1, hi_proc):
                cuts[t] = e if e > b else b
            return
        m1 = k // 2
        m2 = k - m1
        # target split proportional to processor counts; try both (m1, m2)
        # orders when k is odd and keep the better per-processor load.
        best = None
        for mm1, mm2 in {(m1, m2), (m2, m1)}:
            target = p[b] + (p[e] - p[b]) * (mm1 / k)
            for cand in search.split_candidates(p, b - 1, e + 1, target):
                cand = min(max(cand, b), e)
                cost = max((p[cand] - p[b]) / mm1, (p[e] - p[cand]) / mm2)
                if best is None or cost < best[0]:
                    best = (cost, cand, mm1)
        _, s, mm1 = best
        cuts[lo_proc + mm1] = s
        rec(b, s, lo_proc, lo_proc + mm1)
        rec(s, e, lo_proc + mm1, hi_proc)

    rec(0, n, 0, m)
    return np.asarray(cuts, dtype=np.int64)


# ---------------------------------------------------------------------------
# Exact algorithms


def dp_optimal(p: np.ndarray, m: int) -> np.ndarray:
    """Manne-Olstad DP. f_j(i) = min_k max(f_{j-1}(k), p[i]-p[k]).

    f_{j-1} is non-decreasing in k and p[i]-p[k] non-increasing, so the inner
    min is over a bi-monotonic function: binary search. O(m n log n).
    """
    n = len(p) - 1
    f = (p[1:n + 1] - p[0]).astype(np.float64)  # j = 1
    arg = [np.zeros(n, dtype=np.int64)]
    for _ in range(2, m + 1):
        g = np.empty(n, dtype=np.float64)
        ka = np.empty(n, dtype=np.int64)
        for i in range(1, n + 1):
            # smallest k where f[k-1] >= p[i] - p[k] (bi-monotonic crossing)
            lo = search.bisect_index(
                lambda k: (f[k - 1] if k > 0 else 0.0) >= p[i] - p[k],
                0, i - 1)
            best, bk = np.inf, lo
            for k in (lo - 1, lo):
                if k < 0 or k > i:
                    continue
                fk = f[k - 1] if k > 0 else 0.0
                v = max(fk, float(p[i] - p[k]))
                if v < best:
                    best, bk = v, k
            g[i - 1], ka[i - 1] = best, bk
        f = g
        arg.append(ka)
    # backtrack
    cuts = np.zeros(m + 1, dtype=np.int64)
    cuts[m] = n
    i = n
    for j in range(m - 1, 0, -1):
        i = int(arg[j][i - 1]) if i > 0 else 0
        cuts[j] = i
    return cuts


def probe(p: np.ndarray, m: int, L: float,
          speeds: np.ndarray | None = None) -> np.ndarray | None:
    """Greedy feasibility: pack intervals of load <= L; None if infeasible.

    Each step extends the current interval maximally via one binary search
    on the prefix array (Han et al.), O(m log n).

    With ``speeds``, interval ``i`` runs on processor ``i`` and must keep
    its *relative* load ``(p[e]-p[b]) / speeds[i] <= L`` (capacity
    ``L * speeds[i]``).  Unlike the homogeneous greedy, empty intervals
    are allowed mid-chain: a dead (``speed=0``) or too-slow processor is
    simply skipped and its share shifts to later, faster ones — maximal
    extension stays exact for the fixed processor order.
    """
    _C.scalar_probes += 1
    n = len(p) - 1
    if speeds is not None:
        cuts = np.empty(m + 1, dtype=np.int64)
        cuts[0] = 0
        b = 0
        for i in range(1, m + 1):
            cap = L * float(speeds[i - 1])
            if cap > 0:
                e = int(np.searchsorted(p, p[b] + cap, side="right")) - 1
                b = min(max(e, b), n)
            cuts[i] = b
        return cuts if b >= n else None
    cuts = np.empty(m + 1, dtype=np.int64)
    cuts[0] = 0
    b = 0
    for i in range(1, m + 1):
        if p[n] - p[b] <= L:  # remainder fits in one interval
            cuts[i:] = [b] * (m - i) + [n]
            return cuts
        e = int(np.searchsorted(p, p[b] + L, side="right")) - 1
        if e <= b:
            return None  # single element exceeds L
        cuts[i] = e
        b = e
    return None if b < n else cuts


def probe_count(p: np.ndarray, L: float, cap: int, start: int = 0,
                speeds: np.ndarray | None = None) -> int:
    """#intervals of load <= L covering p[start:]; > cap returned as cap+1.

    Works in-place on the full prefix array (no rebasing copy), so a call is
    O(k log n) for k resulting intervals.

    With ``speeds`` (the per-position capacity schedule this chain will
    consume, in order), the count is the number of schedule positions
    consumed: position ``k`` packs at most ``L * speeds[k]``, and a
    zero-speed position is consumed with an empty interval rather than
    declaring the chain stuck.
    """
    _C.scalar_probes += 1
    n = len(p) - 1
    if speeds is not None:
        b = start
        for k in range(int(cap)):
            if b >= n:
                return max(k, 1)
            sp = float(speeds[k]) if k < len(speeds) else 0.0
            if sp > 0:
                e = int(np.searchsorted(p, p[b] + L * sp, side="right")) - 1
                b = min(max(e, b), n)
        return max(int(cap), 1) if b >= n else int(cap) + 1
    b, cnt = start, 0
    while b < n:
        if cnt >= cap:
            return cap + 1
        if p[n] - p[b] <= L:
            return cnt + 1
        e = int(np.searchsorted(p, p[b] + L, side="right")) - 1
        if e <= b:
            return cap + 1
        b = e
        cnt += 1
    return max(cnt, 1)


def _lower_bound(p: np.ndarray, m: int) -> float:
    n = len(p) - 1
    maxel = float((p[1:] - p[:-1]).max(initial=0))
    return max(float(p[n]) / m, maxel)


def probe_bisect_optimal(p: np.ndarray, m: int, *, warm: float | None = None,
                         speeds: np.ndarray | None = None) -> np.ndarray:
    """Exact optimal for integer loads: wide bisection on L with ``probe``.

    UB is the DirectCut bound sum/m + max (Section 2.2); the multi-L engine
    resolves ~log_{K+1} rounds instead of log_2.  For float inputs this
    converges to within 1e-9 relative (documented).

    ``warm`` is an optional bottleneck from a previous plan on a similar
    instance (``serve.batcher.replan``, the rebalance runtime).  One probe
    classifies it — feasible tightens ``hi``, infeasible raises ``lo`` — so
    the bisection only has to resolve the *drift* since the last plan.

    ``speeds`` switches the objective to the heterogeneous-capacity one:
    minimize ``max_i (p[c_{i+1}]-p[c_i]) / speeds[i]`` over the fixed
    processor order (Tzovas et al.).  Uniform vectors normalize away and
    take the homogeneous path bit-identically; zero-load arrays also do
    (every interval is empty — relative load 0 for any speeds, and this
    keeps all-zero-speed slices of empty stripes legal).  ``warm`` is then
    a *relative* bottleneck.
    """
    n = len(p) - 1
    if n == 0:
        return np.zeros(m + 1, dtype=np.int64)
    if speeds is not None and float(p[n] - p[0]) > 0:
        speeds = search.normalize_speeds(speeds, m)
    else:
        speeds = None
    if speeds is not None:
        return _probe_bisect_hetero(p, m, speeds, warm=warm)
    integral = np.issubdtype(p.dtype, np.integer)
    lo = _lower_bound(p, m)
    hi = float(p[n]) / m + float((p[1:] - p[:-1]).max(initial=0))
    if warm is not None and lo < warm < hi:
        if probe(p, m, float(warm)) is not None:
            hi = float(warm)
        else:
            lo = np.floor(warm) + 1 if integral else float(warm)
    if n * m <= 2048:
        # tiny problems (the jag-m DPs' stripe costs): scalar probes beat
        # packed chains; same halving midpoints as the seed loop.
        L = search.bisect_bottleneck_scalar(
            lambda Lc: probe(p, m, Lc) is not None,
            lo, hi, integral=integral)
    else:
        packed = search.PackedPrefixes(p[None, :])
        L = search.bisect_bottleneck(
            lambda Ls: packed.counts(Ls, m)[0] <= m, lo, hi,
            integral=integral)
    return search.realize(lambda Lc: probe(p, m, Lc), L, integral=integral)


def _probe_bisect_hetero(p: np.ndarray, m: int, speeds: np.ndarray, *,
                         warm: float | None = None) -> np.ndarray:
    """Capacity-aware bisection on relative load (speeds pre-normalized).

    Exact for the fixed processor order: the greedy probe allows empty
    intervals, so slow/dead positions are skipped and feasibility stays
    monotone in L.  Heterogeneous capacities are not integral even on
    integer loads, so this always runs the float bisection (1e-9
    relative).  ``hi`` is everything-on-the-fastest-processor — reachable
    because the probe may leave every other position empty — padded by an
    ulp so float rounding cannot push the greedy below feasibility at
    exactly ``hi``.
    """
    n = len(p) - 1
    total = float(p[n] - p[0])
    maxel = float((p[1:] - p[:-1]).max(initial=0))
    smax = float(speeds.max())
    lo = max(total / float(speeds.sum()), maxel / smax)
    hi = (total / smax) * (1 + 1e-9) + 1e-12
    if warm is not None and lo < warm < hi:
        if probe(p, m, float(warm), speeds) is not None:
            hi = float(warm)
        else:
            lo = float(warm)
    if n * m <= 2048:
        L = search.bisect_bottleneck_scalar(
            lambda Lc: probe(p, m, Lc, speeds) is not None,
            lo, hi, integral=False)
    else:
        packed = search.PackedPrefixes(p[None, :])
        L = search.bisect_bottleneck(
            lambda Ls: packed.counts(Ls, m, speeds=speeds)[0] <= m,
            lo, hi, integral=False)
    return search.realize(lambda Lc: probe(p, m, Lc, speeds), L,
                          integral=False)


def optimal_1d_batch(ps, ms) -> list[np.ndarray]:
    """Many independent optimal-1D problems solved through one packed probe.

    ``ps``: list of prefix arrays (or an ``(S, n+1)`` matrix), ``ms``: the
    per-array interval counts.  Equivalent to
    ``[probe_bisect_optimal(p, m) for p, m in zip(ps, ms)]`` but every
    (array, candidate-L) greedy chain advances under a single searchsorted
    per probe step — this is the JAG-M realization hot path.
    """
    plist = list(ps)
    ms = [int(m) for m in ms]
    if not plist:
        return []
    los = np.empty(len(plist))
    his = np.empty(len(plist))
    caps = np.array(ms, dtype=np.int64)[:, None]
    for s, (p, m) in enumerate(zip(plist, ms)):
        n = len(p) - 1
        maxel = float((p[1:] - p[:-1]).max(initial=0)) if n else 0.0
        total = float(p[n]) if n else 0.0
        los[s] = max(total / m, maxel)
        his[s] = total / m + maxel
    integral = all(np.issubdtype(p.dtype, np.integer) for p in plist)
    arr = np.asarray(plist) if len({len(p) for p in plist}) == 1 else plist
    packed = search.PackedPrefixes(arr)
    Lstars = search.bisect_bottleneck_batch(
        lambda Ls, rows: packed.counts(Ls, caps[rows], rows=rows)
        <= caps[rows],
        los, his, integral=integral)
    out = []
    for p, m, L in zip(plist, ms, Lstars):
        if len(p) - 1 == 0:
            out.append(np.zeros(m + 1, dtype=np.int64))
            continue
        out.append(search.realize(lambda Lc: probe(p, m, Lc), L,
                                  integral=integral))
    return out


def nicol_optimal(p: np.ndarray, m: int,
                  speeds: np.ndarray | None = None) -> np.ndarray:
    """Nicol's parametric search: exact for arbitrary (float) loads.

    With ``speeds``, the parametric chain does not transfer — its
    candidate bottlenecks are realizable interval *sums* ``L(b, e)``,
    while heterogeneous bottlenecks are sums scaled by per-position
    speeds — so this routes to the capacity-aware relative-load bisection
    (:func:`probe_bisect_optimal`), which is exact for the fixed order to
    1e-9 relative.

    For each leading processor j, in an optimal solution its interval is
    either (a) the bottleneck -- then it is the *smallest* e with
    Probe(L(b, e)) feasible for the remaining array/processors, giving the
    candidate bottleneck L(b, e*); or (b) not the bottleneck -- then it can
    safely be extended to e*-1 (the largest infeasible end) and we recurse.
    The optimum is the best candidate seen along the chain (Nicol 1994;
    engineering per Pinar-Aykanat 2004). O((m log n)^2)-ish.
    """
    if speeds is not None:
        speeds = search.normalize_speeds(speeds, m)
    if speeds is not None:
        return probe_bisect_optimal(p, m, speeds=speeds)
    n = len(p) - 1
    best_L = float(p[n] - p[0])  # j covers everything candidate
    b = 0
    committed = 0.0
    for j in range(1, m):
        if b >= n:
            break
        k = m - j + 1  # processors available for suffix [b, n)
        # NicolPlus-style range tightening (sound): feasibility needs
        # L(b, e) >= suffix_total / k, so start the search there.
        suffix_avg = float(p[n] - p[b]) / k
        lo = int(np.searchsorted(p, p[b] + suffix_avg, side="left"))
        lo = max(lo, b + 1)
        lo = search.bisect_index(
            lambda mid: probe_count(p, float(p[mid] - p[b]), k, start=b) <= k,
            lo, n)
        cand = max(committed, float(p[lo] - p[b]))
        if cand < best_L:
            best_L = cand
        # extend safely to lo - 1 and recurse on the suffix
        nb = max(lo - 1, b)
        committed = max(committed, float(p[nb] - p[b]))
        b = nb
    best_L = min(best_L, max(committed, float(p[n] - p[b])))
    # float rounding in searchsorted(p[b] + L) can make the exact optimum
    # infeasible by an ulp; search.realize bumps L until the probe lands.
    return search.realize(lambda Lc: probe(p, m, Lc), best_L, integral=False)


def optimal_1d(p: np.ndarray, m: int, *, warm: float | None = None,
               speeds: np.ndarray | None = None) -> np.ndarray:
    """Default exact 1D partitioner (probe-bisection; see module docstring).

    ``speeds`` minimizes the relative bottleneck ``load_i / speeds[i]``
    over the fixed processor order; dead (``speed=0``) positions receive
    empty intervals.

    ``warm`` is a *probe-count* optimization only: a known-feasible upper
    bound (e.g. the previous frame's bottleneck) tightens the bisection's
    starting interval so fewer candidates are probed.  It never changes
    the returned cuts — the bisection converges to the same minimal
    feasible bottleneck from any valid bracket (regression-tested in
    ``tests/test_search_equivalence.py``).
    """
    return probe_bisect_optimal(p, m, warm=warm, speeds=speeds)


# ---------------------------------------------------------------------------
# Multi-array machinery (paper Section 3.2.2: PROBE-M / JAG-M-PROBE engine)


def probe_multi(ps: list[np.ndarray], m: int, L: float,
                speeds: np.ndarray | None = None) -> list[int] | None:
    """PROBE-M: processors needed per array for bottleneck L; None if > m.

    Every (non-empty) array needs at least one processor (its elements must
    be covered by intervals inside that array).  With ``speeds``, the
    arrays consume a prefix of the fixed processor order and each array's
    greedy runs against its own slice of the remaining speed schedule.
    """
    counts = []
    used = 0
    for p in ps:
        c = probe_count(p, L, m - used,
                        speeds=None if speeds is None else speeds[used:])
        if used + c > m:
            return None
        counts.append(c)
        used += c
    return counts


def nicol_multi(ps: list[np.ndarray], m: int,
                speeds: np.ndarray | None = None
                ) -> tuple[float, list[int], list[np.ndarray]]:
    """Optimal multi-array partition: wide bisection on L with PROBE-M.

    Returns (bottleneck, per-array processor counts summing to <= m,
    per-array cut arrays). Exact for integer loads; 1e-9-relative for float.
    After finding L*, leftover processors are spread greedily to the arrays
    with the highest per-processor load (never hurts the bottleneck).

    With ``speeds`` (length ``m``, the fixed processor order the arrays
    consume as a prefix), everything runs on relative load — bottleneck,
    bisection, per-array cuts — and dead (``speed=0``) positions receive
    empty intervals.  Counts then sum to exactly ``m``.
    """
    if speeds is not None:
        speeds = search.normalize_speeds(speeds, m)
    totals = np.array([float(p[-1]) for p in ps])
    maxels = np.array([float((p[1:] - p[:-1]).max(initial=0)) for p in ps])
    total = totals.sum()
    if total == 0:
        counts = [1] * len(ps)
        cuts = [np.zeros(2, dtype=np.int64) for _ in ps]
        for p, c in zip(ps, cuts):
            c[1] = len(p) - 1
        return 0.0, counts, cuts
    if m < len(ps):
        raise ValueError(f"need m >= #arrays, got m={m} arrays={len(ps)}")
    if speeds is not None:
        return _nicol_multi_hetero(ps, m, speeds, totals, maxels, total)
    lo = max(total / m, maxels.max(initial=0.0))
    hi = float(totals.max(initial=0.0))  # one interval per array: feasible
    integral = all(np.issubdtype(p.dtype, np.integer) for p in ps)
    arr = np.asarray(ps) if len({len(p) for p in ps}) == 1 else ps
    packed = search.PackedPrefixes(arr)
    best_L = search.bisect_bottleneck(
        lambda Ls: packed.counts(Ls, m).sum(axis=0) <= m,
        lo, hi, integral=integral)
    best_counts = search.realize(lambda Lc: probe_multi(ps, m, Lc), best_L,
                                 integral=integral)
    # distribute leftover processors greedily by load-per-processor
    counts = list(best_counts)
    left = m - sum(counts)
    for _ in range(left):
        s = int(np.argmax(totals / np.array(counts, dtype=np.float64)))
        counts[s] += 1
    # realize each array's cuts optimally with its processor count
    cuts = optimal_1d_batch(ps, counts)
    bott = max(max_interval_load(p, c) for p, c in zip(ps, cuts))
    return bott, counts, cuts


def _rel_interval_loads(p: np.ndarray, cuts: np.ndarray,
                        speeds: np.ndarray) -> np.ndarray:
    """Per-interval relative loads ``load_i / speeds[i]``.

    Zero-load intervals are 0 regardless of speed (a dead position with an
    empty interval is fine); a *loaded* zero-speed interval comes back inf,
    which is exactly the signal callers want to see for an invalid plan.
    """
    cuts = np.asarray(cuts)
    loads = (p[cuts[1:]] - p[cuts[:-1]]).astype(np.float64)
    sp = np.asarray(speeds, dtype=np.float64)[:loads.size]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(loads > 0, loads / sp, 0.0)


def _nicol_multi_hetero(ps, m, speeds, totals, maxels, total):
    """PROBE-M on heterogeneous capacity (speeds pre-normalized).

    The arrays consume a prefix of the fixed processor order; position
    ``i``'s capacity is ``L * speeds[i]``.  Needs at least as many
    positive-speed positions as arrays (each non-empty array must reach a
    positive position of its own).  At ``hi`` — total load over the
    slowest of the first ``S`` positive positions — array ``s`` can cover
    everything from the ``s``-th positive position with empty intervals
    padding the gaps, so ``hi`` is feasible.  Leftover positions go to the
    *last* array only, keeping every earlier array on the exact speed
    prefix the probe solved it for.
    """
    S = len(ps)
    pos = np.flatnonzero(speeds > 0)
    if pos.size < S:
        raise ValueError(f"need >= {S} positive-speed processors for "
                         f"{S} arrays, got {pos.size}")
    smax = float(speeds.max())
    lo = max(total / float(speeds.sum()), float(maxels.max(initial=0)) / smax)
    hi = (total / float(speeds[pos[:S]].min())) * (1 + 1e-9) + 1e-12
    L = search.bisect_bottleneck_scalar(
        lambda Lc: probe_multi(ps, m, Lc, speeds) is not None, lo, hi,
        integral=False)
    counts = list(search.realize(
        lambda Lc: probe_multi(ps, m, Lc, speeds), L, integral=False))
    counts[-1] += m - sum(counts)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cuts = [optimal_1d(p, int(c), speeds=speeds[offs[s]:offs[s + 1]])
            for s, (p, c) in enumerate(zip(ps, counts))]
    bott = max(float(_rel_interval_loads(
        p, c, speeds[offs[s]:offs[s + 1]]).max(initial=0.0))
        for s, (p, c) in enumerate(zip(ps, cuts)))
    return bott, counts, cuts
