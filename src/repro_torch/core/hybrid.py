"""HYBRID two-phase partitioning — paper Section 5, engine-native.

The port's NumPy copy of ``repro.core.hybrid``: the same code in the same
order of floating-point operations, so its results are bit-identical.

Phase 1 partitions A into P rectangles with JAG-M-HEUR; each part is
allocated Q_r = ceil((m-P) * L(r)/L(A)) processors (leftovers greedily);
phase 2 partitions each part independently with Q_r processors.

Engineering from the paper:
- fast/slow phase 2: solve every part with the *fast* algorithm
  (JAG-M-HEUR-PROBE), then repeatedly re-optimize the most-loaded part
  with the *slow* algorithm while it improves.
- expected load imbalance (eLI = max_r L(r)/Q_r) predicts the achieved LI
  when phase 2 is (near-)optimal, so P is chosen by scanning candidate P
  values (ends of the ceil((m-P)/P) plateaus) and running phase 2 only at
  the best expected one.

Unlike the seed implementation — which composed two black-box ``Algo``
callables, re-running phase 1 from scratch for every candidate P and
re-deriving every stripe prefix inside phase 2 — this module is built
directly on the shared probe/bisection engine:

- the expected-LI scan evaluates *all* candidate P values from one
  incremental phase-1 stripe structure: row cuts are solved once per
  distinct stripe count (coarser P shares finer-P structure) and every
  (stripe, q) column split goes through the root
  :class:`~repro_torch.core.stripecache.SubgridView` memo, so a stripe cost
  computed for one candidate is reused by every later one;
- phase 2 packs *every* part's stripe prefixes into one
  :class:`~repro_torch.core.search.PackedPrefixes` set and resolves all
  per-part bottlenecks through ``search.bisect_bottleneck_multi`` — one
  probe round advances every (part, stripe, candidate-L) chain instead of one
  ``bisect_bottleneck`` per part;
- the fast/slow loop re-optimizes the hottest part with the view-based
  exact DP (``jagged.jag_m_opt_view``), warm-seeding each stripe
  bisection with the part's fast-phase bottleneck and sharing stripe
  costs with everything phase 2 already computed (the memo is keyed in
  parent coordinates).

The composed-``Algo`` implementation this replaced lives on verbatim in
``tests/_reference.py``; the equivalence suite asserts the engine-native
pipeline never achieves a worse bottleneck.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import trace as _trace

from . import jagged, oned, search
from .jagged import _proportional_counts
from .stripecache import SubgridView
from .types import Partition, Rect

__all__ = ["candidate_P_values", "expected_li", "hybrid", "hybrid_auto",
           "hybrid_fastslow"]


def _subgamma(gamma: np.ndarray, r: Rect) -> np.ndarray:
    """Gamma of the sub-matrix A[r0:r1, c0:c1], derived from Gamma in O(area)."""
    g = (gamma[r.r0:r.r1 + 1, r.c0:r.c1 + 1]
         - gamma[r.r0:r.r1 + 1, r.c0:r.c0 + 1]
         - gamma[r.r0:r.r0 + 1, r.c0:r.c1 + 1]
         + gamma[r.r0, r.c0])
    return g


def _offset(rects: list[Rect], r: Rect) -> list[Rect]:
    return [Rect(q.r0 + r.r0, q.r1 + r.r0, q.c0 + r.c0, q.c1 + r.c0)
            for q in rects]


# ---------------------------------------------------------------------------
# expected-LI machinery (paper Section 5)


def candidate_P_values(m: int, p_min: int) -> list[int]:
    """Ends of the intervals where ceil((m-P)/P) is constant (paper's scan)."""
    out = []
    P = max(p_min, 2)
    while P <= m // 2:
        v = -(-(m - P) // P)  # ceil
        # largest P' with the same ceil value: ceil((m-P')/P') == v
        # (m - P')/P' <= v  =>  P' >= m/(v+1); plateau end is the largest P
        # with ceil >= v, i.e. P'' = floor(m / v) when v >= 1
        if v >= 1:
            Pend = m // v
            Pend = min(max(Pend, P), m // 2)
        else:
            Pend = m // 2
        out.append(Pend)
        P = Pend + 1
    return sorted(set(out))


def _expected_li(part_loads: np.ndarray, total: float, m: int) -> float:
    """eLI from phase-1 part loads: max_r L(r)/Q_r over the global average."""
    if total == 0:
        return 0.0
    counts = np.asarray(_proportional_counts(part_loads, m),
                        dtype=np.float64)
    # counts are clamped >= 1 upstream; keep the guard local too so a
    # zero-load part can never turn the scan's division into inf/nan
    np.maximum(counts, 1.0, out=counts)
    return float((part_loads / counts).max() / (total / m)) - 1.0


def expected_li(gamma: np.ndarray, part1: Partition, m: int) -> float:
    """eLI = max_r L(r)/Q_r normalized by global average (paper Section 5)."""
    loads = part1.loads(gamma).astype(np.float64)
    return _expected_li(loads, float(gamma[-1, -1]), m)


# ---------------------------------------------------------------------------
# phase 1: incremental JAG-M-HEUR structure shared across candidate P values


class _Phase1Scan:
    """All candidate phase-1 partitions from one shared stripe structure.

    Stripe boundaries only depend on the stripe count P1 = round(sqrt(P)),
    so they are solved once per distinct P1; every (stripe, q) column
    split goes through the root view's parent-coordinate memo
    (``cuts_1d_batch`` — uncached splits of one candidate resolve through
    a single packed probe).  Evaluating a candidate P is then just a
    proportional allocation plus memo lookups — no phase-1 re-run.
    """

    def __init__(self, root: SubgridView):
        self.root = root
        self.rp = root.row_prefix()
        self._rows: dict[int, np.ndarray] = {}

    def _row_cuts(self, P1s: list[int]) -> None:
        """Solve the stripe boundaries for several P1 values in one batch."""
        miss = [P1 for P1 in dict.fromkeys(P1s) if P1 not in self._rows]
        if miss:
            for P1, cuts in zip(miss, oned.optimal_1d_batch(
                    [self.rp] * len(miss), miss)):
                self._rows[P1] = cuts
        return None

    def _jobs(self, P: int) -> list[tuple[int, int, int]]:
        """The (stripe-row-range, q) column-split jobs JAG-M-HEUR at P
        needs; stripe boundaries must already be solved."""
        P1 = min(max(int(round(np.sqrt(P))), 1), P)
        self._row_cuts([P1])
        row_cuts = self._rows[P1]
        stripe_loads = (self.rp[row_cuts[1:]]
                        - self.rp[row_cuts[:-1]]).astype(np.float64)
        counts = _proportional_counts(stripe_loads, P)
        return [(int(row_cuts[s]), int(row_cuts[s + 1]), q)
                for s, q in enumerate(counts)]

    def parts(self, P: int) -> tuple[list[Rect], np.ndarray]:
        """JAG-M-HEUR('hor') at P: the part rectangles and their loads."""
        jobs = self._jobs(P)
        sols = self.root.cuts_1d_batch(jobs)
        rects: list[Rect] = []
        loads: list[np.ndarray] = []
        for (a, b, _), (_, cc) in zip(jobs, sols):
            p = self.root.stripe_prefix(a, b)
            loads.append((p[cc[1:]] - p[cc[:-1]]).astype(np.float64))
            rects.extend(Rect(a, b, int(cc[t]), int(cc[t + 1]))
                         for t in range(len(cc) - 1))
        return rects, np.concatenate(loads) if loads else np.zeros(0)

    def best_P(self, m: int, p_min: int) -> int:
        """The expected-LI scan: smallest eLI over the plateau ends.

        All candidates resolve from the shared structure: stripe
        boundaries once per distinct P1 (one batch), then the *union* of
        every candidate's column-split jobs through one packed probe —
        evaluating a candidate is pure memo lookups after that.
        """
        total = float(self.root.total)
        cands = candidate_P_values(m, p_min)
        self._row_cuts([min(max(int(round(np.sqrt(P))), 1), P)
                        for P in cands])
        jobs_per_P = [self._jobs(P) for P in cands]
        self.root.cuts_1d_batch([j for jobs in jobs_per_P for j in jobs])
        best_P, best_e = None, np.inf
        for P, jobs in zip(cands, jobs_per_P):
            loads = []
            for (a, b, _), (_, cc) in zip(jobs, self.root.cuts_1d_batch(jobs)):
                p = self.root.stripe_prefix(a, b)
                loads.append((p[cc[1:]] - p[cc[:-1]]).astype(np.float64))
            e = _expected_li(np.concatenate(loads) if loads else np.zeros(0),
                             total, m)
            if e < best_e:
                best_e, best_P = e, P
        if best_P is None:
            best_P = max(min(m // 2, p_min), 1)
        return best_P


# ---------------------------------------------------------------------------
# phase 2: all parts through one packed probe state


def _phase2_fast(root: SubgridView, parts: list[Rect], qs: list[int]
                 ) -> list[tuple[float, list[Rect]]]:
    """JAG-M-HEUR-PROBE on every part, batched.

    One ``optimal_1d_batch`` solves all parts' stripe boundaries, one
    ``bisect_bottleneck_multi`` resolves all per-part PROBE-M bottlenecks,
    and one final ``optimal_1d_batch`` realizes every stripe's column
    cuts.  Per-part results are bit-identical to ``jag_m_heur_probe`` on
    the materialized sub-Gamma (the engine only reorders probes).
    Returns ``(bottleneck, rects-in-window-coords)`` per part.
    """
    wins = [root.window(r) for r in parts]
    Ps = [min(max(int(round(np.sqrt(q))), 1), q) for q in qs]
    row_cuts = oned.optimal_1d_batch([w.row_prefix() for w in wins], Ps)

    stripes: list[np.ndarray] = []   # ragged stripe prefixes, part-grouped
    groups: list[int] = []
    los = np.zeros(len(parts))
    his = np.zeros(len(parts))
    for i, (w, rc, q) in enumerate(zip(wins, row_cuts, qs)):
        sm = w.stripe_matrix(rc)
        totals = sm[:, -1].astype(np.float64)
        maxels = np.abs(np.diff(sm, axis=1)).max(axis=1, initial=0.0) \
            if sm.shape[1] > 1 else np.zeros(sm.shape[0])
        stripes.extend(sm)
        groups.extend([i] * sm.shape[0])
        los[i] = max(float(totals.sum()) / q, float(maxels.max(initial=0.0)))
        his[i] = float(totals.max(initial=0.0))
    packed = search.PackedPrefixes(stripes)
    Ls = search.bisect_bottleneck_multi(packed, groups, qs, los, his,
                                        integral=root.integral,
                                        width=15)

    # realize each part at its engine bottleneck (nicol_multi's tail);
    # each part's stripes are a contiguous run of the packed list
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        np.asarray(groups), minlength=len(parts)))])
    all_counts: list[int] = []
    for i, (q, L) in enumerate(zip(qs, Ls)):
        ps = stripes[starts[i]:starts[i + 1]]
        counts = search.realize(lambda Lc: oned.probe_multi(ps, q, Lc), L,
                                integral=root.integral)
        counts = list(counts)
        totals = np.array([float(p[-1]) for p in ps])
        for _ in range(q - sum(counts)):  # spread leftovers greedily
            s = int(np.argmax(totals / np.array(counts, dtype=np.float64)))
            counts[s] += 1
        all_counts.extend(counts)
    col_cuts = oned.optimal_1d_batch(stripes, all_counts)

    out: list[tuple[float, list[Rect]]] = []
    for i, rc in enumerate(row_cuts):
        bott, rects = 0.0, []
        for s in range(starts[i], starts[i + 1]):
            p, cc = stripes[s], col_cuts[s]
            bott = max(bott, oned.max_interval_load(p, cc))
            a, b = int(rc[s - starts[i]]), int(rc[s - starts[i] + 1])
            rects.extend(Rect(a, b, int(cc[t]), int(cc[t + 1]))
                         for t in range(len(cc) - 1))
        out.append((bott, rects))
    return out


def _slow_solve(root: SubgridView, part: Rect, q: int, ub: float, slow
                ) -> tuple[float, list[Rect]]:
    """Slow phase-2 re-optimization of one part; rects in window coords.

    ``slow`` is ``"opt"`` (view-based exact JAG-M-OPT DP, both
    orientations, stripe bisections warm-seeded at the fast bottleneck
    ``ub``), ``"pq"`` (JAG-PQ-OPT on the floor-sqrt grid — the cheap
    quality knob at large q), or any ``Algo``-style
    ``callable(sub_gamma, q) -> Partition``.
    """
    if slow == "opt":
        win = root.window(part)
        bh, rch, cch = jagged.jag_m_opt_view(win, q, warm=ub)
        bv, rcv, ccv = jagged.jag_m_opt_view(win.transposed(), q, warm=ub)
        if bh <= bv:
            rects = [Rect(int(rch[s]), int(rch[s + 1]),
                          int(cc[t]), int(cc[t + 1]))
                     for s, cc in enumerate(cch)
                     for t in range(len(cc) - 1)]
            return bh, rects
        rects = [Rect(int(cc[t]), int(cc[t + 1]),
                      int(rcv[s]), int(rcv[s + 1]))
                 for s, cc in enumerate(ccv)
                 for t in range(len(cc) - 1)]
        return bv, rects
    sg = _subgamma(root.gamma, part)
    if slow == "pq":
        P = max(int(np.sqrt(q)), 1)
        sp = jagged.jag_pq_opt(sg, P * (q // P), P=P, Q=q // P)
    else:
        sp = slow(sg, q)
    return sp.max_load(sg), list(sp.rects)


def _refine(root: SubgridView, parts: list[Rect], qs: list[int],
            sub: list[tuple[float, list[Rect]]], slow, *,
            exhaustive: bool, limit: int) -> None:
    """Fast/slow loop: re-optimize the hottest part while it improves.

    Non-exhaustive (the paper's loop) stops at the first part the slow
    algorithm fails to improve; exhaustive keeps walking the parts in
    load order until ``limit`` of them have been slow-solved — the
    time/quality knob ``hybrid_fastslow`` exposes.
    """
    slowed: set[int] = set()
    while len(slowed) < min(limit, len(parts)):
        order = np.argsort([-s[0] for s in sub], kind="stable")
        i = next((int(j) for j in order if int(j) not in slowed), None)
        if i is None:
            break
        if not exhaustive and int(order[0]) in slowed:
            break  # hottest already slow-optimal: done (paper semantics)
        cur = sub[i][0]
        v, rects = _slow_solve(root, parts[i], qs[i], cur, slow)
        slowed.add(i)
        if v < cur - 1e-12:
            sub[i] = (v, rects)
        elif not exhaustive:
            break


# ---------------------------------------------------------------------------
# public pipeline


def _hybrid_speeds(gamma: np.ndarray, m: int, P: int | None,
                   speeds: np.ndarray) -> Partition:
    """Capacity-aware HYBRID (speeds pre-normalized, genuinely hetero).

    Positions chunk into P contiguous runs of ~equal speed mass; phase 1
    runs capacity-aware JAG-M-HEUR on the aggregate chunk speeds (part
    ``s`` of the phase-1 partition is positionally chunk ``s``), phase 2
    re-partitions each part with capacity-aware JAG-M-HEUR-PROBE on its
    own chunk slice.  The expected-LI scan and the fast/slow refinement
    loop are skipped — both rank parts by *raw* load, which is the wrong
    objective under heterogeneous capacity.  Dead chunks (no positive
    speed) and empty parts emit zero-width rects so the global rect order
    stays positional.
    """
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    if P is None:
        P = max(int(round(np.sqrt(m))), 2)
    P = max(min(P, m, int((speeds > 0).sum())), 1)
    chunk = jagged._speed_chunks(speeds, P)
    gsum = np.add.reduceat(speeds, chunk[:-1])
    part1 = jagged.jag_m_heur(gamma, P, speeds=gsum, orient="hor")
    rects: list[Rect] = []
    for s, r in enumerate(part1.rects):
        lo_pos, hi_pos = int(chunk[s]), int(chunk[s + 1])
        sl = speeds[lo_pos:hi_pos]
        q = hi_pos - lo_pos
        if r.area == 0 or not (sl > 0).any():
            # dead/empty chunk: keep r covered by its first position (the
            # part carries zero load here — phase 1 only hands a dead
            # chunk nonzero area when that area is zero-load), pad the
            # rest with zero-width rects to keep positions aligned.
            rects.append(r)
            rects.extend(Rect(r.r0, r.r0, r.c0, r.c0)
                         for _ in range(q - 1))
            continue
        sub = _subgamma(gamma, r)
        sp = jagged.jag_m_heur_probe(sub, q, speeds=sl, orient="hor")
        sub_rects = _offset(list(sp.rects), r)
        # a zero-load part can come back with fewer than q rects
        # (nicol_multi's degenerate path); pad to keep positions aligned
        while len(sub_rects) < q:
            sub_rects.append(Rect(r.r0, r.r0, r.c0, r.c0))
        assert len(sub_rects) == q, (s, len(sub_rects), q)
        rects.extend(sub_rects)
    return Partition(rects, (n1, n2), m_target=m)


def _hybrid(gamma: np.ndarray, m: int, P: int | None, p_min: int | None,
            slow, refine: bool, exhaustive: bool,
            slow_parts: int | None) -> Partition:
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    if p_min is None:
        p_min = max(int(np.sqrt(m)), 2)
    root = SubgridView(gamma)
    scan = _Phase1Scan(root)
    if P is None:
        with _trace.span("hybrid.scan_P", m=int(m)):
            P = scan.best_P(m, p_min)
    with _trace.span("hybrid.phase1", P=int(P)):
        parts, loads = scan.parts(P)
        qs = _proportional_counts(loads, m)
    with _trace.span("hybrid.phase2_fast", parts=len(parts)):
        sub = _phase2_fast(root, parts, qs)
    if refine:
        limit = len(parts) if slow_parts is None else slow_parts
        with _trace.span("hybrid.refine"):
            _refine(root, parts, qs, sub, slow,
                    exhaustive=exhaustive, limit=limit)
    rects: list[Rect] = []
    for part, (_, rs) in zip(parts, sub):
        rects.extend(_offset(rs, part))
    return Partition(rects, (n1, n2), m_target=m)


def hybrid(gamma: np.ndarray, m: int, P: int | None = None, *,
           p_min: int | None = None, slow="opt", refine: bool = True,
           speeds: np.ndarray | None = None) -> Partition:
    """Engine-native HYBRID (paper's best configuration).

    ``P`` fixes the phase-1 part count; ``P=None`` runs the expected-LI
    scan.  ``refine=False`` skips the fast/slow loop (fast phase 2 only).
    ``speeds`` switches to the capacity-aware two-phase pipeline
    (``_hybrid_speeds``); uniform vectors normalize away and run the
    homogeneous pipeline bit-identically.
    """
    sp = search.normalize_speeds(speeds, m) if speeds is not None else None
    if sp is not None:
        return _hybrid_speeds(gamma, m, P, sp)
    return _hybrid(gamma, m, P, p_min, slow, refine,
                   exhaustive=False, slow_parts=None)


def hybrid_auto(gamma: np.ndarray, m: int, *, p_min: int | None = None,
                slow="opt", refine: bool = True,
                speeds: np.ndarray | None = None) -> Partition:
    """HYBRID with P chosen by the expected-LI scan (paper Figure 16)."""
    sp = search.normalize_speeds(speeds, m) if speeds is not None else None
    if sp is not None:
        return _hybrid_speeds(gamma, m, None, sp)
    return _hybrid(gamma, m, None, p_min, slow, refine,
                   exhaustive=False, slow_parts=None)


def hybrid_fastslow(gamma: np.ndarray, m: int, P: int | None = None, *,
                    p_min: int | None = None, slow="opt",
                    slow_parts: int | None = None,
                    speeds: np.ndarray | None = None) -> Partition:
    """HYBRID's time/quality knob: exhaustive fast/slow refinement.

    Instead of stopping at the first part the slow algorithm fails to
    improve, every part (or the hottest ``slow_parts`` of them) is
    re-optimized in load order — never worse than :func:`hybrid`, at
    slow-phase cost proportional to ``slow_parts``.  With heterogeneous
    ``speeds`` the refinement loop is skipped (it ranks parts by raw
    load), so this coincides with :func:`hybrid`.
    """
    sp = search.normalize_speeds(speeds, m) if speeds is not None else None
    if sp is not None:
        return _hybrid_speeds(gamma, m, P, sp)
    return _hybrid(gamma, m, P, p_min, slow, True,
                   exhaustive=True, slow_parts=slow_parts)
