"""3D m-way jagged partitioning — the paper's Section 6 extension.

The port's NumPy copy of ``repro.core.threed``: the same code in the same
order of floating-point operations, so its results are bit-identical.

"A jagged partitioning algorithm would partition the space along one
dimension and perform a projection to obtain planes which will be
partitioned in stripes and projected to one dimensional arrays" — exactly
this: slabs along axis 0 (optimal 1D on the projected loads), proportional
processor allocation per slab (the JAG-M rule), then a full 2D m-way
jagged partition of each slab.

Engine-native since PR 10: **one** 3D prefix (``prefix.prefix_sum_3d``)
serves every consumer — the slab 1D prefix is its ``[:, -1, -1]`` margin,
any slab's 2D Gamma is the plane difference ``gamma3[x1] - gamma3[x0]``
(no re-summing, the 3D twin of the paper's stripe trick), and
:class:`SlabCache` memoizes the per-slab 2D solves in absolute slab
coordinates so the ``P=None`` auto-sweep and the slab-boundary refinement
share work exactly like ``stripecache.SubgridView`` does for HYBRID.  The
refinement walks each interior slab boundary over the
``search.interior_candidates`` schedule (coordinate descent, improvements
only), so the result is never worse than the unrefined heuristic.

``Partition3D.loads`` / ``is_valid`` are vectorized: loads are one
8-corner inclusion–exclusion gather over the shared prefix, validity one
signed-corner scatter + 3D cumsum (the discrete divergence trick) —
no per-box Python slicing.

This beats projecting the whole 3D volume to 2D up-front (the paper's
PIC-MAG preprocessing) because the slab partition can follow axis-0
heterogeneity that projection destroys — measured in the test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs import trace as _trace
from repro_torch.obs.counters import C as _C

from . import oned, search
from .jagged import _proportional_counts, _speed_chunks, jag_m_heur_probe
from .prefix import prefix_sum_3d

__all__ = ["Box", "Partition3D", "SlabCache", "jag_m_heur_3d",
           "partition3d_from_grid", "project_then_2d", "uniform_3d"]


@dataclasses.dataclass(frozen=True)
class Box:
    """Half-open box [x0,x1) x [r0,r1) x [c0,c1)."""
    x0: int
    x1: int
    r0: int
    r1: int
    c0: int
    c1: int


@dataclasses.dataclass
class Partition3D:
    boxes: list[Box]
    shape: tuple[int, int, int]
    m_target: int | None = None  # requested processor count (>= len(boxes))

    @property
    def m(self) -> int:
        return self.m_target if self.m_target is not None else len(self.boxes)

    def _corners(self) -> np.ndarray:
        """(B, 6) int64 box corner matrix."""
        if not self.boxes:
            return np.zeros((0, 6), dtype=np.int64)
        return np.array([(b.x0, b.x1, b.r0, b.r1, b.c0, b.c1)
                         for b in self.boxes], dtype=np.int64)

    def loads(self, A: np.ndarray, *,
              gamma3: np.ndarray | None = None) -> np.ndarray:
        """Per-box loads by 8-corner inclusion–exclusion over one 3D
        prefix (pass a precomputed ``gamma3`` to skip the prefix build)."""
        if not self.boxes:
            return np.zeros(0)
        g = prefix_sum_3d(A) if gamma3 is None else gamma3
        c = self._corners()
        x0, x1, r0, r1, c0, c1 = (c[:, i] for i in range(6))
        return (g[x1, r1, c1] - g[x0, r1, c1] - g[x1, r0, c1]
                - g[x1, r1, c0] + g[x0, r0, c1] + g[x0, r1, c0]
                + g[x1, r0, c0] - g[x0, r0, c0]).astype(np.float64)

    def max_load(self, A: np.ndarray, *,
                 gamma3: np.ndarray | None = None) -> float:
        return float(self.loads(A, gamma3=gamma3).max(initial=0))

    def load_imbalance(self, A: np.ndarray, m: int | None = None, *,
                       gamma3: np.ndarray | None = None) -> float:
        m = m if m is not None else self.m
        g = prefix_sum_3d(A) if gamma3 is None else gamma3
        total = float(g[-1, -1, -1])
        if total == 0:
            return 0.0
        return float(self.loads(A, gamma3=g).max()) / (total / m) - 1.0

    def is_valid(self) -> bool:
        """Disjointness + coverage without painting per box: scatter the
        signed corner deltas of every box into an (n1+1, n2+1, n3+1)
        field, 3D-cumsum it back to paint counts, check all-ones."""
        n1, n2, n3 = self.shape
        c = self._corners()
        if ((c[:, 0] > c[:, 1]).any() or (c[:, 2] > c[:, 3]).any()
                or (c[:, 4] > c[:, 5]).any() or (c < 0).any()
                or (c[:, 1] > n1).any() or (c[:, 3] > n2).any()
                or (c[:, 5] > n3).any()):
            return False
        delta = np.zeros((n1 + 1, n2 + 1, n3 + 1), dtype=np.int64)
        for sx, xi in ((1, 0), (-1, 1)):
            for sr, ri in ((1, 2), (-1, 3)):
                for sc, ci in ((1, 4), (-1, 5)):
                    np.add.at(delta, (c[:, xi], c[:, ri], c[:, ci]),
                              sx * sr * sc)
        paint = np.cumsum(np.cumsum(np.cumsum(delta, axis=0), axis=1),
                          axis=2)[:n1, :n2, :n3]
        return bool((paint == 1).all())


def partition3d_from_grid(cuts1, cuts2, cuts3,
                          shape: tuple[int, int, int]) -> Partition3D:
    """Rectilinear partition from three per-axis cut vectors, row-major
    cell order (cell (i, j, k) -> processor ``ravel(i, j, k)``)."""
    c1 = np.asarray(cuts1, dtype=np.int64)
    c2 = np.asarray(cuts2, dtype=np.int64)
    c3 = np.asarray(cuts3, dtype=np.int64)
    boxes = [Box(int(c1[i]), int(c1[i + 1]), int(c2[j]), int(c2[j + 1]),
                 int(c3[k]), int(c3[k + 1]))
             for i in range(len(c1) - 1)
             for j in range(len(c2) - 1)
             for k in range(len(c3) - 1)]
    return Partition3D(boxes, tuple(shape))


class SlabCache:
    """Memoized per-slab 2D solves over one shared 3D prefix.

    The 3D twin of ``stripecache.SubgridView``: keys are absolute slab
    coordinates ``(x0, x1, q)``, so a slab solved while evaluating one
    candidate ``P`` (or one refinement candidate boundary) is reused by
    every later candidate that covers the same slab with the same budget.
    A slab's 2D Gamma is the plane difference ``gamma3[x1] - gamma3[x0]``
    — already a valid exclusive prefix (its zero planes survive the
    subtraction), no re-summing, no rebase.
    """

    def __init__(self, gamma3: np.ndarray):
        self.gamma3 = gamma3
        #: (n1+1,) 1D prefix of the slab-projected loads (axis-0 margin)
        self.slab_prefix = np.ascontiguousarray(gamma3[:, -1, -1])
        self._memo: dict[tuple[int, int, int], tuple[float, object]] = {}

    def gamma2(self, x0: int, x1: int) -> np.ndarray:
        """(n2+1, n3+1) exclusive 2D Gamma of slab [x0, x1)."""
        return self.gamma3[x1] - self.gamma3[x0]

    def solve(self, x0: int, x1: int, q: int):
        """Memoized ``(bottleneck, 2D partition)`` of slab [x0, x1) split
        q ways by JAG-M-HEUR-PROBE (hor orientation, the slab idiom)."""
        key = (int(x0), int(x1), int(q))
        _C.slab_lookups += 1
        v = self._memo.get(key)
        if v is None:
            _C.slab_misses += 1
            g2 = self.gamma2(x0, x1)
            part2 = jag_m_heur_probe(g2, q, orient="hor")
            v = (part2.max_load(g2), part2)
            self._memo[key] = v
        else:
            _C.slab_hits += 1
        return v


def _refine_boundaries(cache: SlabCache, bounds: list[list[int]],
                       width: int = 15, passes: int = 2) -> list[list[int]]:
    """Coordinate descent on interior slab boundaries over the
    ``search.interior_candidates`` schedule.

    ``bounds`` is a list of live ``[x0, x1, q]`` slabs (contiguous).  Each
    interior boundary is re-placed at the best of its candidate positions
    (memoized slab costs pay for the sweep); only strict improvements are
    accepted, so the refined bottleneck is <= the heuristic's.
    """
    S = len(bounds)
    if S < 2:
        return bounds
    costs = [cache.solve(x0, x1, q)[0] for x0, x1, q in bounds]
    for _ in range(passes):
        moved = False
        for i in range(1, S):
            (xa, xb, qa), (_, xc, qb) = bounds[i - 1], bounds[i]
            cand = search.interior_candidates(xa, xc, width)
            cand = cand[(cand > xa) & (cand < xc)]
            others = max((c for j, c in enumerate(costs)
                          if j not in (i - 1, i)), default=0.0)
            best_x, best_c = xb, max(costs[i - 1], costs[i])
            for x in cand:
                x = int(x)
                if x == xb:
                    continue
                ca = cache.solve(xa, x, qa)[0]
                cb = cache.solve(x, xc, qb)[0]
                c = max(ca, cb)
                if c < best_c and max(c, others) <= max(best_c, others):
                    best_x, best_c = x, c
            if best_x != xb:
                moved = True
                bounds[i - 1][1] = bounds[i][0] = best_x
                costs[i - 1] = cache.solve(xa, best_x, qa)[0]
                costs[i] = cache.solve(best_x, xc, qb)[0]
        if not moved:
            break
    return bounds


def _solve_for_p(cache: SlabCache, m: int, P: int, *,
                 refine: bool = True) -> tuple[float, Partition3D]:
    """One P-slab homogeneous solve against the shared cache; returns
    ``(bottleneck, partition)``."""
    p = cache.slab_prefix
    n1 = p.shape[0] - 1
    slab_cuts = oned.optimal_1d(p, P)
    loads = (p[slab_cuts[1:]] - p[slab_cuts[:-1]]).astype(np.float64)
    counts = np.asarray(_proportional_counts(loads, m), dtype=np.int64)
    # the 1D slab solve can emit empty slabs (its greedy collapses zero
    # ranges); their processor budget must not vanish with them — hand
    # each orphaned processor to the live slab with the highest load per
    # assigned processor, so the partition still has exactly m boxes
    live = [s for s in range(P)
            if int(slab_cuts[s + 1]) > int(slab_cuts[s])]
    orphaned = int(counts.sum()) - int(counts[live].sum())
    for _ in range(orphaned):
        s = max(live, key=lambda t: loads[t] / counts[t])
        counts[s] += 1
    bounds = [[int(slab_cuts[s]), int(slab_cuts[s + 1]), int(counts[s])]
              for s in live]
    if refine:
        bounds = _refine_boundaries(cache, bounds)
    boxes: list[Box] = []
    bottleneck = 0.0
    n2, n3 = cache.gamma3.shape[1] - 1, cache.gamma3.shape[2] - 1
    for x0, x1, q in bounds:
        cost, part2 = cache.solve(x0, x1, q)
        bottleneck = max(bottleneck, cost)
        for r in part2.rects:
            boxes.append(Box(x0, x1, r.r0, r.r1, r.c0, r.c1))
    return bottleneck, Partition3D(boxes, (n1, n2, n3), m_target=m)


def _jag_m_heur_3d_hetero(cache: SlabCache, m: int, P: int,
                          speeds: np.ndarray) -> Partition3D:
    """Capacity-aware variant: the m-position speed schedule chunks into P
    contiguous runs (as in ``jagged.jag_m_heur``); slab cuts split the
    axis-0 margin on aggregate chunk speeds, each slab's 2D solve packs
    against its own slice.  Boxes come back in processor (position)
    order, zero-volume for empty slabs."""
    P = max(min(P, int((speeds > 0).sum())), 1)
    chunk = _speed_chunks(speeds, P)
    gsum = np.add.reduceat(speeds, chunk[:-1])
    slab_cuts = oned.optimal_1d(cache.slab_prefix, P, speeds=gsum)
    n1 = cache.slab_prefix.shape[0] - 1
    n2, n3 = cache.gamma3.shape[1] - 1, cache.gamma3.shape[2] - 1
    boxes: list[Box] = []
    for s in range(P):
        x0, x1 = int(slab_cuts[s]), int(slab_cuts[s + 1])
        q = int(chunk[s + 1] - chunk[s])
        part2 = jag_m_heur_probe(cache.gamma2(x0, x1), q, orient="hor",
                                 speeds=speeds[chunk[s]:chunk[s + 1]])
        for r in part2.rects:
            boxes.append(Box(x0, x1, r.r0, r.r1, r.c0, r.c1))
    return Partition3D(boxes, (n1, n2, n3), m_target=m)


def jag_m_heur_3d(A: np.ndarray, m: int, P: int | None = None, *,
                  speeds: np.ndarray | None = None,
                  refine: bool = True) -> Partition3D:
    """m-way jagged in 3D: slabs -> per-slab 2D m-way jagged.

    As in the paper's orientation/-BEST variants, the slab count P is hard
    to pick a priori (Theorem 4's parameters are unobservable), so when
    unspecified a few candidates are scanned — all against **one** shared
    3D prefix and slab-solve memo, so the sweep never re-sums a slab.
    """
    A = np.asarray(A)
    n1, n2, n3 = A.shape
    if m > n1 * n2 * n3:
        raise ValueError(f"m={m} exceeds the {n1}x{n2}x{n3} grid's "
                         f"{n1 * n2 * n3} cells")
    sp = search.normalize_speeds(speeds, m) if speeds is not None else None
    with _trace.span("jag_m_heur_3d.prefix", shape=str(A.shape)):
        cache = SlabCache(prefix_sum_3d(A))
    if sp is not None:
        Pc = P if P is not None else max(int(round(m ** 0.5)), 1)
        with _trace.span("jag_m_heur_3d.hetero", P=int(Pc)):
            return _jag_m_heur_3d_hetero(cache, m, min(Pc, m, n1), sp)
    if P is None:
        cands = [Pc for Pc in sorted({2, max(int(round(m ** (1 / 3))), 2),
                                      max(int(round(m ** 0.5)), 2)})
                 if Pc <= min(m, n1)]
        if not cands:
            # every candidate exceeded min(m, n1) — e.g. n1=1 where no
            # multi-slab split exists; a single slab is the only choice
            cands = [1]
        best = None
        with _trace.span("jag_m_heur_3d.sweep", cands=str(cands)):
            for Pc in cands:
                cost, part = _solve_for_p(cache, m, Pc, refine=refine)
                if best is None or cost < best[0]:
                    best = (cost, part)
        return best[1]
    with _trace.span("jag_m_heur_3d.solve", P=int(P)):
        return _solve_for_p(cache, m, min(P, m, n1), refine=refine)[1]


def uniform_3d(A: np.ndarray, px: int, py: int, pz: int) -> Partition3D:
    """The MPI_Cart-style baseline: an area-uniform 3D grid."""
    n1, n2, n3 = A.shape
    xs = np.linspace(0, n1, px + 1).round().astype(int)
    ys = np.linspace(0, n2, py + 1).round().astype(int)
    zs = np.linspace(0, n3, pz + 1).round().astype(int)
    return partition3d_from_grid(xs, ys, zs, A.shape)


def project_then_2d(A: np.ndarray, m: int,
                    algo2d: str = "jag-m-heur-probe") -> Partition3D:
    """The paper's PIC-MAG preprocessing: project axis 0 away, partition
    in 2D (any registry 2D algorithm — ``algo2d``), extrude — the
    suboptimal baseline Section 6 warns about.  (The parameter is not
    called ``algo`` so it can be threaded through measurement helpers
    whose own positional is named that.)"""
    from . import registry
    from .prefix import prefix_sum_2d
    A = np.asarray(A)
    n1 = A.shape[0]
    g2 = prefix_sum_2d(A.sum(axis=0))
    part2 = registry.get(algo2d)(g2, m)
    boxes = [Box(0, n1, r.r0, r.r1, r.c0, r.c1) for r in part2.rects]
    return Partition3D(boxes, A.shape, m_target=m)
