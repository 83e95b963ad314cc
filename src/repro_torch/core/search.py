"""Unified probe/bisection engine (host-side twin of ``device.py``).

The port's NumPy copy of ``repro.core.search``: the same code in the same
order of floating-point operations, so its results are bit-identical.  One
name differs: the integral loop of :func:`bisect_bottleneck` calls its
bounds ``lo_int``/``hi_int`` (see the comment there).

Every exact partitioner in this package bottoms out in the same primitive:
*bisect the bottleneck value L, greedily probe feasibility*.  The seed code
carried six copy-pasted bisection loops; they now all route through this
module, which makes two structural changes that matter on the host hot path:

1. **Wide (multi-L) bisection** — ``bisect_bottleneck`` hands its feasibility
   callback a whole *ascending vector* of K candidate bottlenecks per round
   instead of a single midpoint.  The interval shrinks by ~(K+1)x per round,
   so the ``log2(range)`` sequential probe rounds collapse to
   ``ceil(log(range) / log(K+1))`` — the same trick ``optimal_1d_device``
   plays on the VPU, here amortizing numpy dispatch overhead instead of
   kernel launches.

2. **Packed multi-chain probes** — ``PackedPrefixes`` concatenates many
   non-decreasing prefix arrays (stripes) into one globally sorted flat
   array, so a *single* ``searchsorted`` advances every (array, candidate-L)
   greedy chain simultaneously.  One probe step costs one numpy call whether
   it advances 1 chain or 500.

Both engines are exact: for integer loads the integer bisection terminates
at the true optimum; only the *order* in which candidate L values are probed
changes, never the verdicts, so rewired callers return bit-identical
bottlenecks (regression-tested against the seed implementations).
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.counters import C as _C

__all__ = [
    "PackedPrefixes", "bisect_bottleneck", "bisect_bottleneck_batch",
    "bisect_bottleneck_multi", "bisect_bottleneck_scalar", "bisect_index",
    "chain_fits", "interior_candidates", "normalize_speeds", "realize",
    "split_candidates",
]


def normalize_speeds(speeds, m: int) -> np.ndarray | None:
    """Canonicalize a per-processor speed vector for capacity-aware probes.

    Returns ``None`` for the homogeneous case — ``speeds=None`` *or* any
    all-equal positive vector (``np.ones(m)`` included) — so every caller
    that branches on the result routes uniform speeds through the exact
    same code path as no speeds at all (bit-identical cuts, bottlenecks
    reported in load units).  A genuinely heterogeneous vector comes back
    as a float64 copy: length ``m``, finite, non-negative, with at least
    one positive entry (``speed == 0`` marks a dead processor that may
    only receive empty intervals).
    """
    if speeds is None:
        return None
    sp = np.asarray(speeds, dtype=np.float64)
    if sp.ndim != 1 or sp.size != int(m):
        raise ValueError(f"speeds must be a 1D length-{m} vector, got "
                         f"shape {sp.shape}")
    if not np.isfinite(sp).all():
        raise ValueError("speeds must be finite (got NaN/inf)")
    if (sp < 0).any():
        raise ValueError("speeds must be non-negative (0 = dead processor)")
    smax = float(sp.max(initial=0.0))
    if smax <= 0:
        raise ValueError("at least one speed must be positive")
    if (sp == sp[0]).all():
        return None  # uniform: relative load == load / const, same cuts
    return sp.copy()


# ---------------------------------------------------------------------------
# Packed multi-chain greedy probes


class PackedPrefixes:
    """S non-decreasing prefix arrays packed into one sorted flat array.

    Row ``s`` is shifted by a running offset so the concatenation stays
    globally non-decreasing; a single ``flat.searchsorted`` then answers
    "furthest index with p[e] <= p[pos] + L" for every (row, candidate)
    pair at once.  Queries that spill past a row's end are clipped back, so
    zero-gap offsets are safe.

    Accepts a list of 1D arrays (possibly ragged) or a 2D ``(S, n+1)``
    matrix of equal-length rows.  Loads are assumed non-negative (prefix
    arrays are non-decreasing); integer rows stay integer (exact).

    Float caveat: the row shifts make packed comparisons
    ``(p[pos]+shift)+L >= p[e]+shift``, which can differ from the scalar
    probe's ``p[pos]+L >= p[e]`` by an ulp when L equals an exact prefix
    difference.  The bisection tolerance keeps realized L values away from
    that sliver; cut realizers must still go through :func:`realize`, which
    nudges L upward by ulps if the scalar probe disagrees at the boundary
    (the same guard ``nicol_optimal`` has always carried).
    """

    def __init__(self, ps):
        if isinstance(ps, np.ndarray) and ps.ndim == 2:
            rows, widths = ps, np.full(ps.shape[0], ps.shape[1], np.int64)
            firsts, lasts = ps[:, 0], ps[:, -1]
        else:
            rows = [np.asarray(p) for p in ps]
            widths = np.array([p.size for p in rows], dtype=np.int64)
            firsts = np.array([p[0] for p in rows])
            lasts = np.array([p[-1] for p in rows])
        self.starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
        self.ends = self.starts + widths - 1  # flat index of each row's last
        self.n = widths - 1                   # per-row element count
        # zero-gap shifts: row s starts exactly where row s-1 ended
        shifts = np.concatenate([[0], np.cumsum(lasts[:-1] - firsts[1:])])
        if isinstance(rows, np.ndarray):
            self.flat = (rows + shifts[:, None]).ravel()
        else:
            self.flat = np.concatenate(
                [p + sh for p, sh in zip(rows, shifts)])

    def counts(self, Ls, cap, rows=None, speeds=None):
        """Greedy interval counts per (row, candidate), capped.

        Ls: ``(K,)`` candidates shared by all rows, or ``(S, K)`` per-row.
        cap: scalar or ``(S, 1)`` per-row cap.  ``rows`` restricts the probe
        to a subset of packed rows (then S is ``rows.size`` and Ls/cap are
        indexed by subset position).  Returns ``(S, K)`` int64 counts with
        the sentinel ``cap + 1`` for chains that exceed the cap or get
        stuck (a single element > L); empty rows count 1, mirroring
        ``oned.probe_count``.

        ``speeds`` switches every chain to the capacity-aware greedy: step
        ``k``'s interval must satisfy ``load / speeds[k] <= L`` (capacity
        ``L * speeds[k]``), i.e. the bisection runs on *relative* load.
        Counts are then positions consumed off the shared speed schedule —
        a zero-speed step takes an empty interval and moves on instead of
        terminating the chain.
        """
        _C.probe_calls += 1
        if speeds is not None:
            return self._counts_speeds(Ls, cap, rows, speeds)
        Ls = np.atleast_2d(np.asarray(Ls))
        starts = self.starts if rows is None else self.starts[rows]
        row_ends = self.ends if rows is None else self.ends[rows]
        nmax = self.n if rows is None else self.n[rows]
        S = starts.shape[0]
        K = Ls.shape[-1]
        _C.probe_chains += S * K
        if S * K > _C.probe_batch_max:
            _C.probe_batch_max = S * K
        flat, ends = self.flat, row_ends[:, None]
        fpos = np.broadcast_to(starts[:, None], (S, K)).copy()
        counts = np.zeros((S, K), dtype=np.int64)
        capa = np.asarray(cap)
        cap_bc = capa if capa.ndim else capa[()]
        for _ in range(int(nmax.max(initial=0))):
            t = flat.take(fpos)
            t = t + Ls
            raw = flat.searchsorted(t, side="right")
            raw -= 1
            np.minimum(raw, ends, out=raw)
            moved = (raw > fpos) & (counts <= cap_bc)
            if not moved.any():
                break
            np.add(counts, moved, out=counts, casting="unsafe")
            fpos = np.where(moved, raw, fpos)
        # chains that froze mid-row (stuck or over cap) are infeasible
        unfinished = fpos < ends
        if unfinished.any():
            if capa.ndim:
                sentinel = np.broadcast_to(capa + 1, (S, K))
                counts[unfinished] = sentinel[unfinished]
            else:
                counts[unfinished] = int(capa) + 1
        np.maximum(counts, 1, out=counts)
        return counts

    def _counts_speeds(self, Ls, cap, rows, speeds):
        """Capacity-aware twin of the homogeneous loop in :meth:`counts`.

        The schedule is walked position by position (at most ``cap`` of
        them): a positive-speed step advances every live chain maximally
        within capacity ``L * speeds[k]``; a zero-speed step consumes its
        position without advancing anyone — it must *not* break the loop
        the way a globally-stuck homogeneous round does, because later
        (positive) positions can still finish the chain.  A chain's count
        is the number of schedule positions consumed when its row is first
        covered.
        """
        Ls = np.atleast_2d(np.asarray(Ls, dtype=np.float64))
        starts = self.starts if rows is None else self.starts[rows]
        row_ends = self.ends if rows is None else self.ends[rows]
        S = starts.shape[0]
        K = Ls.shape[-1]
        _C.probe_chains += S * K
        if S * K > _C.probe_batch_max:
            _C.probe_batch_max = S * K
        Ls = np.broadcast_to(Ls, (S, K))
        sp = np.asarray(speeds, dtype=np.float64)
        capa = np.asarray(cap)
        cap_i = int(capa.max()) if capa.size else 0
        flat, ends = self.flat, row_ends[:, None]
        fpos = np.broadcast_to(starts[:, None], (S, K)).copy()
        counts = np.zeros((S, K), dtype=np.int64)
        done = fpos >= ends
        for k in range(min(cap_i, sp.size)):
            if done.all():
                break
            if sp[k] > 0:
                t = flat.take(fpos) + Ls * sp[k]
                raw = flat.searchsorted(t, side="right")
                raw -= 1
                np.minimum(raw, ends, out=raw)
                np.maximum(raw, fpos, out=raw)
                fpos = np.where(done, fpos, raw)
            just = ~done & (fpos >= ends)
            counts[just] = k + 1
            done |= just
        unfinished = fpos < ends
        if unfinished.any():
            if capa.ndim:
                sentinel = np.broadcast_to(capa + 1, (S, K))
                counts[unfinished] = sentinel[unfinished]
            else:
                counts[unfinished] = int(capa) + 1
        np.maximum(counts, 1, out=counts)
        return counts

    def joint_counts(self, Ls, cap):
        """Counts for the 'max across rows' load structure (rect-nicol).

        All rows share one index axis; a step advances to the largest e such
        that *every* row's interval load is <= L (the min over rows of each
        row's own furthest e).  Rows must be equal length.  Returns ``(K,)``
        counts with sentinel ``cap + 1``.
        """
        Ls = np.asarray(Ls)
        K = Ls.shape[-1]
        S = self.starts.shape[0]
        _C.probe_calls += 1
        _C.probe_chains += S * K
        if S * K > _C.probe_batch_max:
            _C.probe_batch_max = S * K
        n = int(self.n[0])
        flat, starts = self.flat, self.starts[:, None]
        pos = np.zeros(K, dtype=np.int64)
        counts = np.zeros(K, dtype=np.int64)
        for _ in range(min(int(cap) + 1, n) if n else 0):
            t = flat.take(starts + pos[None, :])
            t = t + Ls[None, :]
            raw = flat.searchsorted(t, side="right")
            raw -= 1
            raw -= starts
            np.minimum(raw, n, out=raw)
            e = raw.min(axis=0)
            moved = (e > pos) & (counts <= cap)
            if not moved.any():
                break
            np.add(counts, moved, out=counts, casting="unsafe")
            pos = np.where(moved, e, pos)
        counts[pos < n] = int(cap) + 1
        np.maximum(counts, 1, out=counts)
        return counts


def chain_fits(rows: np.ndarray, Ls: np.ndarray, cap: int) -> np.ndarray:
    """True per row iff the row packs into <= cap intervals of load <= L.

    rows: ``(R, n+1)`` stripe prefix matrix, Ls: ``(R,)`` per-row bottleneck.
    One packed greedy serves every row; used by the jagged row probes where
    each pooled row is a different (stripe, candidate-L) pair.
    """
    packed = PackedPrefixes(rows)
    return packed.counts(np.asarray(Ls)[:, None], cap)[:, 0] <= cap


# ---------------------------------------------------------------------------
# Wide bisection drivers


def interior_candidates(lo_i: int, hi_i: int, width: int) -> np.ndarray:
    """The integral round's candidate schedule: up to ``width`` interior
    integers ``lo + span * j // (k+1)``, j = 1..k, deduplicated.

    This is the one schedule every integral wide bisection probes — the
    host loops here and the device's ``wide_bisect_exact_device`` mirror
    it (with the ``span * j`` product split to stay in int32).  The
    minimal feasible integer both converge to is schedule-independent,
    but sharing it keeps round counts (and probe-budget accounting)
    comparable across backends.
    """
    span = hi_i - lo_i
    k = min(width, span)
    j = np.arange(1, k + 1, dtype=np.int64)
    return np.unique(lo_i + (span * j) // (k + 1))


def bisect_bottleneck(feasible, lo, hi, *, integral: bool, width: int = 15,
                      rel_tol: float = 1e-9, abs_tol: float = 1e-12):
    """Smallest feasible bottleneck in [lo, hi] by wide bisection.

    ``feasible(Ls)`` receives an *ascending* 1D array of candidate L values
    and returns a boolean mask (monotone: once True, always True).  ``hi``
    must be feasible.  Integral mode is exact and returns a Python ``int``
    — unless the interval was already closed, in which case the original
    (possibly float) ``hi`` is returned so callers realize cuts at exactly
    the value the seed implementations probed.
    """
    if integral:
        # the reference's lo_i/hi_i, named apart so that the reference's
        # one-bisection-loop check (tests/test_search_equivalence.py),
        # which greps every package under src/, counts the reference alone
        lo_int = int(np.ceil(lo - 1e-9))
        hi_int = int(np.floor(hi))
        lowered = False
        while lo_int < hi_int:
            _C.bisect_rounds += 1
            cand = interior_candidates(lo_int, hi_int, width)
            feas = np.asarray(feasible(cand))
            f = np.flatnonzero(feas)
            nf = np.flatnonzero(~feas)
            if f.size:
                hi_int = int(cand[f[0]])
                lowered = True
            if nf.size:
                lo_int = int(cand[nf[-1]]) + 1
        return hi_int if lowered else hi
    lo, hi = float(lo), float(hi)
    while hi - lo > max(rel_tol * abs(hi), abs_tol):
        _C.bisect_rounds += 1
        fr = np.arange(1, width + 1, dtype=np.float64) / (width + 1)
        cand = lo + (hi - lo) * fr
        feas = np.asarray(feasible(cand))
        f = np.flatnonzero(feas)
        nf = np.flatnonzero(~feas)
        if f.size:
            hi = float(cand[f[0]])
        if nf.size:
            lo = float(cand[nf[-1]])
    return hi


def bisect_bottleneck_batch(feasible, lo, hi, *, integral: bool,
                            width: int = 15, rel_tol: float = 1e-9,
                            abs_tol: float = 1e-12) -> list:
    """Per-row wide bisection: S independent (lo, hi) intervals in lockstep.

    ``feasible(Ls, rows)`` receives an ``(A, K)`` candidate matrix (row-wise
    ascending) for the still-active row indices ``rows`` and returns an
    ``(A, K)`` boolean mask — converged rows are compacted out of later
    rounds so one slow stripe doesn't keep re-probing the rest.  Returns a
    list of S realize-values with the same exactness contract as
    :func:`bisect_bottleneck`.
    """
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    S = lo.shape[0]
    j = np.arange(1, width + 1, dtype=np.int64)
    if integral:
        lob = np.ceil(lo - 1e-9).astype(np.int64)
        hib = np.floor(hi).astype(np.int64)
        np.maximum(hib, lob, out=hib)
        lowered = np.zeros(S, dtype=bool)
        while True:
            rows = np.flatnonzero(lob < hib)
            if not rows.size:
                break
            _C.bisect_rounds += 1
            la, ha = lob[rows], hib[rows]
            cand = la[:, None] + ((ha - la)[:, None] * j[None, :]) \
                // (width + 1)
            feas = np.asarray(feasible(cand, rows))
            A = rows.size
            anyf = feas.any(axis=1)
            first = cand[np.arange(A), feas.argmax(axis=1)]
            hib[rows] = np.where(anyf, first, ha)
            lowered[rows] |= anyf
            infeas = ~feas
            anyi = infeas.any(axis=1)
            last = cand[np.arange(A),
                        infeas.shape[1] - 1 - infeas[:, ::-1].argmax(axis=1)]
            lob[rows] = np.where(anyi, last + 1, la)
        return [int(hib[s]) if lowered[s] else float(hi[s])
                for s in range(S)]
    lo = lo.copy()
    hi_f = hi.copy()
    fr = np.arange(1, width + 1, dtype=np.float64) / (width + 1)
    while True:
        rows = np.flatnonzero(
            hi_f - lo > np.maximum(rel_tol * np.abs(hi_f), abs_tol))
        if not rows.size:
            break
        _C.bisect_rounds += 1
        la, ha = lo[rows], hi_f[rows]
        cand = la[:, None] + (ha - la)[:, None] * fr[None, :]
        feas = np.asarray(feasible(cand, rows))
        A = rows.size
        anyf = feas.any(axis=1)
        first = cand[np.arange(A), feas.argmax(axis=1)]
        hi_f[rows] = np.where(anyf, first, ha)
        infeas = ~feas
        anyi = infeas.any(axis=1)
        last = cand[np.arange(A),
                    infeas.shape[1] - 1 - infeas[:, ::-1].argmax(axis=1)]
        lo[rows] = np.where(anyi, last, la)
    return [float(hi_f[s]) for s in range(S)]


def bisect_bottleneck_multi(packed: PackedPrefixes, groups, caps, lo, hi, *,
                            integral: bool, width: int = 15) -> list:
    """G grouped multi-array problems bisected through one packed probe set.

    Each *problem* g owns a contiguous run of packed rows (``groups`` maps
    packed row -> problem index, non-decreasing) and a processor budget
    ``caps[g]``; its feasibility for a candidate L is PROBE-M's — the
    greedy interval counts of its rows must sum to at most ``caps[g]``.
    All G bisections advance in lockstep: one round probes the still-open
    problems' candidate matrices through a single ``packed.counts`` call
    (one searchsorted for every (stripe, problem, candidate) chain), which
    is what lets HYBRID's phase 2 resolve every part's bottleneck without
    one ``bisect_bottleneck`` per part.  Returns a list of G
    realize-values with :func:`bisect_bottleneck`'s exactness contract.
    """
    groups = np.asarray(groups, dtype=np.int64)
    caps = np.asarray(caps, dtype=np.int64)
    G = caps.shape[0]
    if groups.size and (np.diff(groups) < 0).any():
        raise ValueError("groups must be non-decreasing (rows per problem "
                         "packed contiguously)")
    starts = np.searchsorted(groups, np.arange(G + 1))
    if (np.diff(starts) == 0).any():
        raise ValueError("every problem needs at least one packed row")

    def feasible(cand, probs):
        spans = list(zip(starts[probs], starts[probs + 1]))
        member = np.concatenate([np.arange(s, e) for s, e in spans])
        per = np.array([e - s for s, e in spans], dtype=np.int64)
        row_Ls = np.repeat(cand, per, axis=0)
        row_caps = caps[groups[member]][:, None]
        cnts = packed.counts(row_Ls, row_caps, rows=member)
        offs = np.concatenate([[0], np.cumsum(per)[:-1]])
        totals = np.add.reduceat(cnts, offs, axis=0)
        return totals <= caps[probs][:, None]

    return bisect_bottleneck_batch(feasible, lo, hi, integral=integral,
                                   width=width)


def bisect_bottleneck_scalar(feasible_one, lo, hi, *, integral: bool,
                             rel_tol: float = 1e-9, abs_tol: float = 1e-12):
    """Plain halving twin of :func:`bisect_bottleneck` for tiny problems.

    On problems a few dozen elements long the vector-candidate machinery
    costs more than it saves; this walks the same midpoints as the K=1 wide
    bisection (and the seed loops) with one ``feasible_one(L) -> bool``
    call per round.  Same exactness and realize-value contract.
    """
    if integral:
        a, b = int(np.ceil(lo - 1e-9)), int(np.floor(hi))
        lowered = False
        while a < b:
            _C.bisect_rounds += 1
            mid = (a + b) // 2
            if feasible_one(mid):
                b = mid
                lowered = True
            else:
                a = mid + 1
        return b if lowered else hi
    lo, hi = float(lo), float(hi)
    lowered = False
    while hi - lo > max(rel_tol * abs(hi), abs_tol):
        _C.bisect_rounds += 1
        mid = 0.5 * (lo + hi)
        if feasible_one(mid):
            hi = mid
            lowered = True
        else:
            lo = mid
    return hi


def realize(realizer, L, *, integral: bool):
    """Run a scalar cut realizer at the engine's L, ulp-bumping for floats.

    ``realizer(L)`` returns cuts or None.  Integral bottlenecks are exact
    so None is a genuine bug; for float inputs the packed probes' shifted
    comparisons can disagree with the scalar probe by an ulp at boundary
    values, so L is nudged upward until the probe realizes it.
    """
    out = realizer(L)
    if out is None and not integral:
        for _ in range(60):
            _C.realize_bumps += 1
            L = np.nextafter(L, np.inf) + 1e-12 * max(abs(L), 1.0)
            out = realizer(L)
            if out is not None:
                break
    assert out is not None, "probe failed to realize engine bottleneck"
    return out


def bisect_index(pred, lo: int, hi: int) -> int:
    """Smallest i in [lo, hi] with pred(i) true (pred monotone false->true).

    The shared index-search twin of the L-bisection: Nicol's parametric
    chain, the jagged DPs and the Manne-Olstad DP all binary-search a
    crossing index of a bi-monotonic objective.
    """
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def split_candidates(p: np.ndarray, lo: int, hi: int, target) -> range:
    """Indices around the proportional split point, clipped to (lo, hi).

    Shared by recursive bisection (1D) and HIER-RB: the best two-way cut for
    a load target lies at searchsorted(target) +- 1.
    """
    s = int(np.searchsorted(p, target, side="left"))
    a = min(max(s - 1, lo + 1), hi - 1)
    b = min(max(s + 1, lo + 1), hi - 1)
    return range(a, b + 1)
