"""Jagged partitions — paper Section 3.2 (the paper's main contribution).

The port's NumPy copy of ``repro.core.jagged``: the same code in the same
order of floating-point operations, so its results are bit-identical.

P x Q-way jagged:
- ``jag_pq_heur``       JAG-PQ-HEUR: optimal 1D on the main-dim projection,
                        then optimal 1D inside each stripe (Thm 1 bound).
- ``jag_pq_opt``        JAG-PQ-OPT (Nicol form): exact P x Q-way jagged via
                        wide bisection + a probe whose interval cost is the
                        stripe's optimal Q-way bottleneck (monotone).

m-way jagged (introduced by the paper):
- ``jag_m_heur``        JAG-M-HEUR: P=sqrt(m) stripes; Q_S proportional to
                        stripe load (ceil over m-P procs, leftovers greedy).
- ``jag_m_probe``       JAG-M-PROBE: given stripes, the optimal processor
                        counts + cuts via PROBE-M bisection (nicol_multi).
- ``jag_m_heur_probe``  JAG-M-HEUR-PROBE: JAG-M-HEUR stripes + JAG-M-PROBE.
- ``jag_m_alloc``       JAG-M-ALLOC: optimal stripe boundaries for a given
                        sequence of per-stripe processor counts (DP).
- ``jag_m_opt``         JAG-M-OPT: exact m-way jagged DP with the paper's
                        pruning (binary search on k, memoized 1D, B&B upper
                        bound from JAG-M-HEUR-PROBE).

All bisections route through :mod:`repro_torch.core.search` (wide multi-L
probes) and stripe prefixes through :mod:`repro_torch.core.stripecache`
(cached, zero-copy ``gamma[r1] - gamma[r0]`` buffers); bottleneck values
are bit-identical to the seed implementations — only the probe order changed.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.obs import trace as _trace

from . import oned, search
from .prefix import row_prefix, transpose_gamma
from .stripecache import StripeView, SubgridView, stripe_matrix
from .types import Partition, from_row_cuts_and_col_cuts

# ---------------------------------------------------------------------------
# helpers


def _build(gamma, row_cuts, col_cuts_list) -> Partition:
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    return from_row_cuts_and_col_cuts(row_cuts, col_cuts_list, (n1, n2))


def _relative_max_load(part: Partition, gamma: np.ndarray,
                       speeds: np.ndarray) -> float:
    """Bottleneck on relative load: rect ``i`` belongs to processor ``i``
    (positional — the builders keep zero-width rects, so the order is the
    processor order).  Zero-load rects are 0 whatever their speed; a
    *loaded* dead processor comes back inf."""
    loads = part.loads(gamma).astype(np.float64)
    sp = np.asarray(speeds, dtype=np.float64)[:loads.size]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(loads > 0, loads / sp, 0.0)
    return float(rel.max(initial=0.0))


def _with_orientation(fn):
    """Add orient='hor'|'ver'|'best' handling to a gamma-based algorithm.

    ``speeds`` is normalized here, before any branching: uniform vectors
    are *dropped* from the kwargs so both orientations — and the 'best'
    comparison — run the exact homogeneous code path (bit-identical to
    ``speeds=None``; a relative comparison could flip ties through float
    division otherwise).  Speeds index processors, not grid axes, so the
    vector passes to the transposed call unchanged; with heterogeneous
    speeds the 'best' pick compares relative bottlenecks.
    """

    @functools.wraps(fn)
    def wrapped(gamma, m, *args, orient: str = "best", **kw):
        if kw.get("speeds") is not None:
            sp = search.normalize_speeds(kw["speeds"], m)
            if sp is None:
                kw.pop("speeds")
            else:
                kw["speeds"] = sp
        elif "speeds" in kw:
            kw.pop("speeds")
        if orient == "hor":
            return fn(gamma, m, *args, **kw)
        if orient == "ver":
            part = fn(transpose_gamma(gamma), m, *args, **kw)
            rects = [type(r)(r.c0, r.c1, r.r0, r.r1) for r in part.rects]
            return Partition(rects, (part.shape[1], part.shape[0]))
        h = wrapped(gamma, m, *args, orient="hor", **kw)
        v = wrapped(gamma, m, *args, orient="ver", **kw)
        sp = kw.get("speeds")
        if sp is not None:
            return h if (_relative_max_load(h, gamma, sp)
                         <= _relative_max_load(v, gamma, sp)) else v
        return h if h.max_load(gamma) <= v.max_load(gamma) else v

    return wrapped


def _speed_chunks(speeds: np.ndarray, P: int) -> np.ndarray:
    """Chunk the m-position speed vector into P contiguous non-empty runs
    of roughly equal speed mass (DirectCut on the speed prefix).

    The chunk sums act as stripe-level aggregate speeds; each stripe's
    columns then split over its own chunk.  Zero-speed runs can collapse a
    DirectCut chunk to nothing, so the cuts are pushed apart (forward then
    backward) to keep every chunk non-empty — needs ``m >= P``.
    """
    m = len(speeds)
    if m < P:
        raise ValueError(f"need m >= P, got m={m} P={P}")
    sp = np.concatenate([[0.0],
                         np.cumsum(np.asarray(speeds, dtype=np.float64))])
    cuts = oned.direct_cut(sp, P).astype(np.int64)
    for i in range(1, P):
        cuts[i] = max(cuts[i], cuts[i - 1] + 1)
    for i in range(P - 1, 0, -1):
        cuts[i] = min(cuts[i], cuts[i + 1] - 1)
    return cuts


def _default_pq(m: int) -> tuple[int, int]:
    P = int(round(np.sqrt(m)))
    if P * P != m:
        raise ValueError(f"m={m} not square; pass P (and Q) explicitly")
    return P, P


def _stripe_matrix(gamma: np.ndarray, row_cuts) -> np.ndarray:
    """(P, n2+1) stripe column-prefix arrays in one gather."""
    row_cuts = np.asarray(row_cuts)
    return stripe_matrix(gamma, row_cuts[:-1], row_cuts[1:])


# ---------------------------------------------------------------------------
# P x Q-way jagged


@_with_orientation
def jag_pq_heur(gamma: np.ndarray, m: int, P: int | None = None,
                Q: int | None = None,
                speeds: np.ndarray | None = None) -> Partition:
    if P is None or Q is None:
        P, Q = _default_pq(m)
    if speeds is not None:
        # stripe s owns the contiguous positions [s*Q, (s+1)*Q) (row-major
        # rect order); rows split on aggregate stripe speeds, columns on
        # each stripe's own slice.
        gsum = np.add.reduceat(speeds, np.arange(0, P * Q, Q))
        row_cuts = oned.optimal_1d(row_prefix(gamma), P, speeds=gsum)
        sm = _stripe_matrix(gamma, row_cuts)
        col_cuts = [oned.optimal_1d(sm[s], Q,
                                    speeds=speeds[s * Q:(s + 1) * Q])
                    for s in range(P)]
        return _build(gamma, row_cuts, col_cuts)
    row_cuts = oned.optimal_1d(row_prefix(gamma), P)
    col_cuts = oned.optimal_1d_batch(_stripe_matrix(gamma, row_cuts),
                                     [Q] * P)
    return _build(gamma, row_cuts, col_cuts)


class _RowProbe:
    """Greedy row probe for JAG-PQ-OPT, vectorized over K candidate Ls.

    A stripe step must find the largest row end ``e`` whose stripe packs
    into Q column intervals of load <= L.  Two NicolPlus-style bounds pin
    the answer into a (usually tiny) window before any packing probe runs:

    - ``e_ub``: largest e with stripe load <= Q*L (necessary);
    - ``e_lo``: largest e with stripe load <= Q*(L - Mu), Mu the largest
      column sum at ``e_ub`` — the DirectCut bound makes this e feasible.

    The window is then resolved by pooled multi-chain packing probes
    (``search.chain_fits``): every (candidate-L, candidate-e) pair is one
    packed row, so a probe step costs one searchsorted for the whole pool.
    """

    def __init__(self, gamma: np.ndarray, P: int, Q: int):
        self.gamma = gamma
        self.rp = row_prefix(gamma)
        self.n1 = gamma.shape[0] - 1
        self.P, self.Q = P, Q
        self.sv = StripeView(gamma)

    def feasible_many(self, Ls: np.ndarray) -> np.ndarray:
        Ls = np.asarray(Ls)
        K = Ls.shape[0]
        g, rp, n1, Q = self.gamma, self.rp, self.n1, self.Q
        b = np.zeros(K, dtype=np.int64)
        done = np.zeros(K, dtype=bool)
        failed = np.zeros(K, dtype=bool)
        QL = Q * Ls
        for _ in range(self.P):
            act = ~(done | failed)
            if not act.any():
                break
            rb = rp.take(b)
            e_ub = rp.searchsorted(rb + QL, side="right") - 1
            np.minimum(e_ub, n1, out=e_ub)
            Mu = np.diff(stripe_matrix(g, b, e_ub), axis=1).max(axis=1)
            e_lo = rp.searchsorted(rb + Q * np.maximum(Ls - Mu, 0),
                                   side="right") - 1
            np.minimum(e_lo, e_ub, out=e_lo)
            np.maximum(e_lo, b, out=e_lo)
            glo = np.where(act, e_lo, b)
            ghi = np.where(act, e_ub + 1, b)
            wj = np.arange(1, 9, dtype=np.int64)
            while True:
                wopen = act & (ghi - glo > 1)
                if not wopen.any():
                    break
                wk = np.flatnonzero(wopen)
                W = (ghi - glo)[wk]
                es = glo[wk, None] + (W[:, None] * wj[None, :]) // 9
                rows_k = np.repeat(wk, wj.size)
                rows_e = es.ravel()
                # drop the known-feasible lower edge and in-row duplicates
                key = rows_k * np.int64(n1 + 2) + rows_e
                _, idx = np.unique(key, return_index=True)
                keep = idx[rows_e.take(idx) > glo.take(rows_k.take(idx))]
                rows_k = rows_k.take(keep)
                rows_e = rows_e.take(keep)
                mat = stripe_matrix(g, b.take(rows_k), rows_e)
                good = search.chain_fits(mat, Ls.take(rows_k), Q)
                np.maximum.at(glo, rows_k[good], rows_e[good])
                np.minimum.at(ghi, rows_k[~good], rows_e[~good])
            e_star = glo
            newly_failed = act & (e_star <= b)
            failed |= newly_failed
            adv = act & ~newly_failed
            b = np.where(adv, e_star, b)
            done |= adv & (b >= n1)
        return done

    def _fits(self, b: int, e: int, L) -> bool:
        return self.sv.count(b, e, L, self.Q) <= self.Q

    def _largest_e(self, b: int, L) -> int:
        rp, n1, Q = self.rp, self.n1, self.Q
        e_ub = int(rp.searchsorted(rp[b] + Q * L, side="right")) - 1
        e_ub = min(e_ub, n1)
        if e_ub <= b:
            return b
        Mu = np.diff(self.sv.prefix(b, e_ub)).max()
        e_lo = int(rp.searchsorted(rp[b] + Q * max(L - Mu, 0),
                                   side="right")) - 1
        e_lo = min(max(e_lo, b), e_ub)
        if self._fits(b, e_ub, L):
            return e_ub
        first_bad = search.bisect_index(
            lambda e: not self._fits(b, e, L), e_lo + 1, e_ub)
        return first_bad - 1

    def cuts(self, L) -> np.ndarray | None:
        """Row cuts realizing bottleneck L (seed ``probe_rows`` semantics)."""
        P, n1 = self.P, self.n1
        cuts = np.empty(P + 1, dtype=np.int64)
        cuts[0] = 0
        b = 0
        for i in range(1, P + 1):
            if self._fits(b, n1, L):
                cuts[i:] = [b] * (P - i) + [n1]
                return cuts
            e = self._largest_e(b, L)
            if e <= b:
                return None
            cuts[i] = e
            b = e
        return None


@_with_orientation
def jag_pq_opt(gamma: np.ndarray, m: int, P: int | None = None,
               Q: int | None = None,
               speeds: np.ndarray | None = None) -> Partition:
    """Exact P x Q jagged: wide-bisect L; the probe greedily extends each
    stripe to the largest row range whose optimal Q-way bottleneck is <= L
    (the cost of a stripe is monotone non-decreasing in its row range).

    With ``speeds``, L is the *relative* bottleneck and each stripe packs
    against its own Q-position speed slice (see ``_jag_pq_opt_hetero``).
    """
    if P is None or Q is None:
        P, Q = _default_pq(m)
    if speeds is not None:
        return _jag_pq_opt_hetero(gamma, m, P, Q, speeds)
    lo = float(gamma[-1, -1]) / m
    with _trace.span("jag_pq_opt.bound", P=P, Q=Q):
        heur = jag_pq_heur(gamma, m, P=P, Q=Q, orient="hor")
        hi = heur.max_load(gamma)
    integral = np.issubdtype(gamma.dtype, np.integer)
    rprobe = _RowProbe(gamma, P, Q)
    with _trace.span("jag_pq_opt.bisect", P=P, Q=Q):
        L = search.bisect_bottleneck(rprobe.feasible_many, lo, hi,
                                     integral=integral, width=31)
    with _trace.span("jag_pq_opt.realize"):
        best_cuts = search.realize(rprobe.cuts, L, integral=integral)
        col_cuts = oned.optimal_1d_batch(_stripe_matrix(gamma, best_cuts),
                                         [Q] * P)
    return _build(gamma, best_cuts, col_cuts)


def _jag_pq_opt_hetero(gamma: np.ndarray, m: int, P: int, Q: int,
                       speeds: np.ndarray) -> Partition:
    """Exact P x Q jagged on relative load (speeds pre-normalized).

    Scalar bisection on L; the row probe extends stripe ``s`` to the
    largest row range packing into its own speed slice
    ``speeds[s*Q:(s+1)*Q]`` at capacity ``L * speed`` per position.
    Coverage is monotone in the row range (domination), so the largest-e
    search is a bisection; a dead stripe (all-zero slice) simply does not
    advance — an empty stripe, legal in the hetero greedy.
    """
    n1 = gamma.shape[0] - 1
    sv = StripeView(gamma)
    rp = row_prefix(gamma)

    def _largest_e(b: int, s: int, L: float) -> int:
        sl = speeds[s * Q:(s + 1) * Q]
        cap_tot = L * float(sl.sum())
        if cap_tot <= 0:
            return b
        e_ub = int(rp.searchsorted(rp[b] + cap_tot, side="right")) - 1
        e_ub = min(max(e_ub, b), n1)
        if e_ub <= b:
            return b

        def fits(e: int) -> bool:
            return oned.probe_count(sv.prefix(b, e), L, Q, speeds=sl) <= Q

        if fits(e_ub):
            return e_ub
        first_bad = search.bisect_index(lambda e: not fits(e), b + 1, e_ub)
        return first_bad - 1

    def cuts(L: float) -> np.ndarray | None:
        out = np.empty(P + 1, dtype=np.int64)
        out[0] = 0
        b = 0
        for s in range(P):
            b = _largest_e(b, s, L)
            out[s + 1] = b
        return out if b >= n1 else None

    heur = jag_pq_heur(gamma, m, P=P, Q=Q, speeds=speeds, orient="hor")
    lo = float(gamma[-1, -1]) / float(speeds.sum())
    hi = max(_relative_max_load(heur, gamma, speeds), lo) \
        * (1 + 1e-9) + 1e-12
    L = search.bisect_bottleneck_scalar(
        lambda Lc: cuts(Lc) is not None, lo, hi, integral=False)
    best_cuts = search.realize(cuts, L, integral=False)
    sm = _stripe_matrix(gamma, best_cuts)
    col_cuts = [oned.optimal_1d(sm[s], Q, speeds=speeds[s * Q:(s + 1) * Q])
                for s in range(P)]
    return _build(gamma, best_cuts, col_cuts)


# ---------------------------------------------------------------------------
# m-way jagged


def _proportional_counts(stripe_loads: np.ndarray, m: int) -> list[int]:
    """Paper's allocation: ceil((m-P) * load/total), leftovers to the stripe
    maximizing load / Q_S.

    Every count is clamped to >= 1 — a zero-load stripe must still own a
    processor (its rows exist and must be covered), and a zero count would
    poison the expected-LI scan's ``loads / counts`` with inf/nan.  Needs
    ``m >= P``; the shave loop can only run out of shaveable counts when
    that is violated.
    """
    stripe_loads = np.asarray(stripe_loads, dtype=np.float64)
    P = len(stripe_loads)
    if m < P:
        raise ValueError(f"need m >= #stripes, got m={m} stripes={P}")
    total = float(stripe_loads.sum())
    if total == 0:
        counts = np.ones(P, dtype=np.int64)
    else:
        counts = np.ceil((m - P) * stripe_loads / total).astype(np.int64)
        counts = np.maximum(counts, 1)
    left = m - int(counts.sum())
    for _ in range(max(left, 0)):
        s = int(np.argmax(stripe_loads / counts))
        counts[s] += 1
    while counts.sum() > m:  # ceil overshoot (rare; shave lightest-loaded)
        cands = np.where(counts > 1)[0]
        s = cands[np.argmin(stripe_loads[cands] / counts[cands])]
        counts[s] -= 1
    return [int(c) for c in counts]


@_with_orientation
def jag_m_heur(gamma: np.ndarray, m: int, P: int | None = None,
               speeds: np.ndarray | None = None) -> Partition:
    if P is None:
        P = max(int(round(np.sqrt(m))), 1)
    P = min(P, m)
    rp = row_prefix(gamma)
    if speeds is not None:
        # positions chunk into P contiguous runs of ~equal speed mass;
        # rows split on the aggregate chunk speeds, each stripe's columns
        # on its own chunk slice.  Chunk widths replace the proportional
        # count allocation (counts are fixed by the position mapping).
        P = max(min(P, int((speeds > 0).sum())), 1)
        chunk = _speed_chunks(speeds, P)
        gsum = np.add.reduceat(speeds, chunk[:-1])
        row_cuts = oned.optimal_1d(rp, P, speeds=gsum)
        sm = _stripe_matrix(gamma, row_cuts)
        col_cuts = [oned.optimal_1d(sm[s], int(chunk[s + 1] - chunk[s]),
                                    speeds=speeds[chunk[s]:chunk[s + 1]])
                    for s in range(P)]
        return _build(gamma, row_cuts, col_cuts)
    row_cuts = oned.optimal_1d(rp, P)
    loads = (rp[row_cuts[1:]] - rp[row_cuts[:-1]]).astype(np.float64)
    counts = _proportional_counts(loads, m)
    col_cuts = oned.optimal_1d_batch(_stripe_matrix(gamma, row_cuts), counts)
    return _build(gamma, row_cuts, col_cuts)


def jag_m_probe_given_stripes(gamma: np.ndarray, m: int,
                              row_cuts: np.ndarray,
                              speeds: np.ndarray | None = None) -> Partition:
    """JAG-M-PROBE: optimal counts + cuts for fixed main-dimension stripes."""
    ps = _stripe_matrix(gamma, row_cuts)
    _, _, cuts = oned.nicol_multi(list(ps), m, speeds=speeds)
    return _build(gamma, row_cuts, cuts)


@_with_orientation
def jag_m_heur_probe(gamma: np.ndarray, m: int, P: int | None = None,
                     speeds: np.ndarray | None = None) -> Partition:
    """JAG-M-HEUR-PROBE: stripes from JAG-M-HEUR, allocation by JAG-M-PROBE."""
    if P is None:
        P = max(int(round(np.sqrt(m))), 1)
    P = min(P, m)
    if speeds is not None:
        # PROBE-M hands stripes contiguous position runs in order, so the
        # row cuts are seeded from the same chunked aggregate speeds; the
        # probe then resolves the exact counts against the full schedule.
        P = max(min(P, int((speeds > 0).sum())), 1)
        chunk = _speed_chunks(speeds, P)
        gsum = np.add.reduceat(speeds, chunk[:-1])
        row_cuts = oned.optimal_1d(row_prefix(gamma), P, speeds=gsum)
        return jag_m_probe_given_stripes(gamma, m, row_cuts, speeds=speeds)
    with _trace.span("jag_m_heur_probe.rows", P=P):
        row_cuts = oned.optimal_1d(row_prefix(gamma), P)
    with _trace.span("jag_m_heur_probe.probe_m"):
        return jag_m_probe_given_stripes(gamma, m, row_cuts)


@_with_orientation
def jag_m_alloc(gamma: np.ndarray, m: int, counts: list[int] | None = None,
                P: int | None = None) -> Partition:
    """JAG-M-ALLOC: optimal stripe boundaries for a fixed ordered sequence of
    per-stripe processor counts. DP over (stripe index, start row) with
    binary search on the split (bi-monotonic objective)."""
    n1 = gamma.shape[0] - 1
    if counts is None:
        # default: take counts from JAG-M-HEUR's proportional allocation
        if P is None:
            P = max(int(round(np.sqrt(m))), 1)
        P = min(P, m)
        rp = row_prefix(gamma)
        rc = oned.optimal_1d(rp, P)
        loads = (rp[rc[1:]] - rp[rc[:-1]]).astype(np.float64)
        counts = _proportional_counts(loads, m)
    if sum(counts) != m:
        raise ValueError("counts must sum to m")
    P = len(counts)
    sv = SubgridView(gamma)

    @functools.lru_cache(maxsize=None)
    def f(s: int, r0: int) -> tuple[float, int]:
        """Best bottleneck covering rows [r0, n1) with stripes s..P-1."""
        if s == P - 1:
            return sv.cost(r0, n1, counts[s]), n1
        # stripe_cost(r0, r, q) increases with r, f(s+1, r) decreases with
        # r: the min of their max sits at the crossing index (+-1).
        cr = search.bisect_index(
            lambda r: sv.cost(r0, r, counts[s]) >= f(s + 1, r)[0], r0, n1)
        best = (np.inf, n1)
        for r in (cr - 1, cr, cr + 1):
            if r < r0 or r > n1:
                continue
            v = max(sv.cost(r0, r, counts[s]), f(s + 1, r)[0])
            if v < best[0]:
                best = (v, r)
        return best

    # backtrack
    row_cuts = [0]
    r = 0
    for s in range(P - 1):
        r = f(s, r)[1]
        row_cuts.append(r)
    row_cuts.append(n1)
    col_cuts = oned.optimal_1d_batch(_stripe_matrix(gamma, row_cuts), counts)
    f.cache_clear()
    return _build(gamma, np.asarray(row_cuts), col_cuts)


def jag_m_opt_view(view: SubgridView, m: int, *, warm: float | None = None
                   ) -> tuple[float, np.ndarray, list[np.ndarray]]:
    """JAG-M-OPT core on a :class:`SubgridView` window ('hor' orientation).

    Returns ``(bottleneck, row_cuts, col_cuts)`` in window coordinates.
    Stripe costs route through the view's parent-coordinate memo, so a
    caller re-optimizing overlapping windows (HYBRID's fast/slow loop)
    never recomputes a stripe's 1D optimum; ``warm`` seeds each fresh
    stripe bisection with a known bottleneck (e.g. the window's fast-phase
    solution) — one probe turns it into a tightened bound.
    """
    n1 = view.n1
    rp = view.row_prefix()
    cost = functools.partial(view.cost, warm=warm)

    @functools.lru_cache(maxsize=None)
    def L(k: int, q: int) -> float:
        """Optimal bottleneck for rows [0, k) on q processors."""
        if k == 0:
            return 0.0
        if q <= 0:
            return np.inf
        load_k = float(rp[k] - rp[0])
        if load_k == 0:
            return 0.0
        lb = load_k / q  # can never beat the average
        best = np.inf
        for x in range(1, q + 1):
            if best <= lb * (1 + 1e-12):
                break  # branch-and-bound: already at the lower bound
            # binary search on k': L(k', q-x) increases with k',
            # stripe_cost(k', k, x) decreases with k'
            lo = search.bisect_index(
                lambda mid: L(mid, q - x) >= cost(mid, k, x), 0, k - 1)
            for kp in (lo - 1, lo, lo + 1):
                if kp < 0 or kp >= k:
                    continue
                v = max(L(kp, q - x), cost(kp, k, x))
                if v < best:
                    best = v
        return best

    # fill + backtrack
    L(n1, m)

    def backtrack(k: int, q: int) -> list[tuple[int, int, int]]:
        """Return list of (r0, r1, x) stripes."""
        if k == 0:
            return []
        target = L(k, q)
        for x in range(1, q + 1):
            for kp in range(k - 1, -1, -1):
                v = max(L(kp, q - x), cost(kp, k, x))
                if v <= target + 1e-9:
                    return backtrack(kp, q - x) + [(kp, k, x)]
        raise AssertionError("backtrack failed")

    stripes = backtrack(n1, m)
    row_cuts = np.asarray([0] + [s[1] for s in stripes], dtype=np.int64)
    sols = [view.cuts_1d(r0, r1, x) for r0, r1, x in stripes]
    col_cuts = [cc for _, cc in sols]
    bott = max((c for c, _ in sols), default=0.0)
    L.cache_clear()
    return bott, row_cuts, col_cuts


@_with_orientation
def jag_m_opt(gamma: np.ndarray, m: int) -> Partition:
    """JAG-M-OPT: exact m-way jagged partition (paper Section 3.2.2 DP).

    L(k, q) = min over k' < k, 1 <= x <= q of
              max(L(k', q - x), opt1d(stripe[k', k), x)).
    Pruning: (1) the average-load lower bound stops the x scan early,
    (2) per-(k', k, x) stripe costs are memoized (:class:`SubgridView`),
    (3) the k' scan is a binary search on the bi-monotonic crossing.
    Polynomial but heavy — intended for small instances / benchmarking the
    heuristics' gap, exactly like the paper (31 min at m=961 in their C++).
    """
    _, row_cuts, col_cuts = jag_m_opt_view(SubgridView(gamma), m)
    return _build(gamma, row_cuts, col_cuts)
