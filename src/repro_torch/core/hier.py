"""Hierarchical bipartitions — paper Section 3.3.

The port's NumPy copy of ``repro.core.hier``: the same code in the same
order of floating-point operations, so its results are bit-identical.

- ``hier_rb``      HIER-RB (Berger-Bokhari recursive bisection). Variants:
                   'hor'/'ver' alternate the cut dimension starting with
                   rows/cols; 'dist' cuts the longer dimension; 'load' tries
                   both dimensions and keeps the better expected balance.
- ``hier_relaxed`` HIER-RELAXED: at each node pick (dimension, cut, j)
                   minimizing max(L1/j, L2/(m-j)) — the dynamic program's
                   step with recursive calls replaced by average loads.
                   Vectorized over all cut positions via Gamma slices.
- ``hier_opt``     HIER-OPT: the exact DP over (rectangle, m). Polynomial
                   but heavy; for small instances / tests only (the paper
                   did not even run it: "expected to run in hours").

Stripe prefix arrays come from a root :class:`SubgridView` — its
``dim_prefix`` serves both orientations from one reused buffer each, the
same windowed access HYBRID's phase-2 machinery uses.  A bisection tree
touches O(m) nodes and the seed allocated two fresh O(n) arrays at each;
the view reuses one buffer per orientation.  The proportional-split
candidate scan is shared with 1D recursive bisection via
``search.split_candidates``.
"""
from __future__ import annotations

import functools

import numpy as np

from . import search
from .prefix import rect_load
from .stripecache import SubgridView
from .types import Partition, Rect


def _views(gamma: np.ndarray) -> SubgridView:
    """Root window over gamma; ``dim_prefix`` replaces the seed's per-node
    stripe re-materialization."""
    return SubgridView(gamma)


def _dim_prefix(views: SubgridView, r: Rect, dim: int
                ) -> tuple[int, int, np.ndarray]:
    """(lo, hi, prefix array along dim) for cutting rect r along dim.

    The returned array lives in the view's shared buffer.
    """
    return views.dim_prefix(r, dim)


def _best_cut_relaxed(gamma: np.ndarray, views, r: Rect, m: int):
    """min over (dim, cut, j) of max(L1/j, L2/(m-j)); vectorized over cuts.

    For each candidate cut the optimal j is the proportional split
    j* ~ m * L1 / (L1 + L2); we evaluate floor/ceil (and +-1) of it.
    Returns (cost, dim, cut, j).
    """
    total = rect_load(gamma, r.r0, r.r1, r.c0, r.c1)
    best = (np.inf, 0, r.r0 + 1, 1)
    for dim in (0, 1):
        lo, hi, p = _dim_prefix(views, r, dim)
        if hi - lo < 2:
            continue
        cuts = np.arange(lo + 1, hi)
        l1 = (p[cuts] - p[lo]).astype(np.float64)
        l2 = float(total) - l1
        with np.errstate(divide="ignore", invalid="ignore"):
            jstar = m * l1 / np.maximum(l1 + l2, 1e-300)
        for jc in (np.floor(jstar), np.ceil(jstar)):
            j = np.clip(jc, 1, m - 1)
            cost = np.maximum(l1 / j, l2 / (m - j))
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                best = (float(cost[i]), dim, int(cuts[i]), int(j[i]))
    return best


def hier_relaxed(gamma: np.ndarray, m: int, variant: str = "load"
                 ) -> Partition:
    """HIER-RELAXED. variant: 'load' (paper's best), 'dist', 'hor', 'ver'.

    'load' uses the full relaxed-DP step (both dims); the others restrict
    the dimension choice like their HIER-RB counterparts.
    """
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    views = _views(gamma)
    rects: list[Rect] = []

    def rec(r: Rect, k: int, depth: int) -> None:
        if k == 1 or r.area <= 1:
            rects.append(r)
            return
        cost, dim, cut, j = _best_cut_relaxed(gamma, views, r, k)
        if variant == "hor":
            want = depth % 2
        elif variant == "ver":
            want = 1 - depth % 2
        elif variant == "dist":
            want = 0 if (r.r1 - r.r0) >= (r.c1 - r.c0) else 1
        else:
            want = None
        if want is not None and dim != want:
            forced = _best_cut_dim(gamma, views, r, k, want)
            if forced is not None:
                cost, dim, cut, j = forced
        if not np.isfinite(cost):
            rects.append(r)  # cannot split further; single (possibly fat) part
            return
        if dim == 0:
            a, b = Rect(r.r0, cut, r.c0, r.c1), Rect(cut, r.r1, r.c0, r.c1)
        else:
            a, b = Rect(r.r0, r.r1, r.c0, cut), Rect(r.r0, r.r1, cut, r.c1)
        rec(a, j, depth + 1)
        rec(b, k - j, depth + 1)

    rec(Rect(0, n1, 0, n2), m, 0)
    return Partition(rects, (n1, n2))


def _best_cut_dim(gamma: np.ndarray, views, r: Rect, m: int, dim: int):
    """Relaxed best (cut, j) restricted to one dimension."""
    total = rect_load(gamma, r.r0, r.r1, r.c0, r.c1)
    lo, hi, p = _dim_prefix(views, r, dim)
    if hi - lo < 2:
        return None
    cuts = np.arange(lo + 1, hi)
    l1 = (p[cuts] - p[lo]).astype(np.float64)
    l2 = float(total) - l1
    best = None
    with np.errstate(divide="ignore", invalid="ignore"):
        jstar = m * l1 / np.maximum(l1 + l2, 1e-300)
    for jc in (np.floor(jstar), np.ceil(jstar)):
        j = np.clip(jc, 1, m - 1)
        cost = np.maximum(l1 / j, l2 / (m - j))
        i = int(np.argmin(cost))
        if best is None or cost[i] < best[0]:
            best = (float(cost[i]), dim, int(cuts[i]), int(j[i]))
    return best


def hier_rb(gamma: np.ndarray, m: int, variant: str = "load") -> Partition:
    """HIER-RB: split into two ~equal-load halves, recurse with m//2 |
    m - m//2 processors. variant as in the paper: 'load', 'dist', 'hor',
    'ver'."""
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    views = _views(gamma)
    rects: list[Rect] = []

    def split_scores(r: Rect, k: int, dim: int):
        """Best (cost, cut, j) for halving along dim with k1=k//2 procs."""
        total = rect_load(gamma, r.r0, r.r1, r.c0, r.c1)
        lo, hi, p = _dim_prefix(views, r, dim)
        if hi - lo < 2:
            return None
        k1 = k // 2
        best = None
        for j in {k1, k - k1}:
            target = p[lo] + float(total) * (j / k)
            for cand in search.split_candidates(p, lo, hi, target):
                l1 = float(p[cand] - p[lo])
                cost = max(l1 / j, (float(total) - l1) / (k - j))
                if best is None or cost < best[0]:
                    best = (cost, cand, j)
        return best

    def rec(r: Rect, k: int, depth: int) -> None:
        if k == 1 or r.area <= 1:
            rects.append(r)
            return
        if variant == "hor":
            dims = [depth % 2]
        elif variant == "ver":
            dims = [1 - depth % 2]
        elif variant == "dist":
            dims = [0 if (r.r1 - r.r0) >= (r.c1 - r.c0) else 1]
        else:  # 'load': try both, keep the better expected balance
            dims = [0, 1]
        best = None
        for dim in dims:
            sc = split_scores(r, k, dim)
            if sc is not None and (best is None or sc[0] < best[0]):
                best = (*sc, dim)
        if best is None:
            # degenerate thin rectangle: try the other dimension
            for dim in (0, 1):
                sc = split_scores(r, k, dim)
                if sc is not None and (best is None or sc[0] < best[0]):
                    best = (*sc, dim)
        if best is None:
            rects.append(r)
            return
        _, cut, j, dim = best
        if dim == 0:
            a, b = Rect(r.r0, cut, r.c0, r.c1), Rect(cut, r.r1, r.c0, r.c1)
        else:
            a, b = Rect(r.r0, r.r1, r.c0, cut), Rect(r.r0, r.r1, cut, r.c1)
        rec(a, j, depth + 1)
        rec(b, k - j, depth + 1)

    rec(Rect(0, n1, 0, n2), m, 0)
    return Partition(rects, (n1, n2))


def hier_opt(gamma: np.ndarray, m: int) -> Partition:
    """HIER-OPT: exact hierarchical bipartition DP (paper Eq. 1-5).

    O(n1^2 n2^2 m^2 log max(n1, n2)) — small instances only.
    """
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1

    @functools.lru_cache(maxsize=None)
    def f(r0: int, r1: int, c0: int, c1: int, k: int) -> float:
        total = float(rect_load(gamma, r0, r1, c0, c1))
        if k == 1:
            return total
        if total == 0:
            return 0.0
        best = total
        for j in range(1, k):
            for x in range(r0 + 1, r1):
                v = max(f(r0, x, c0, c1, j), f(x, r1, c0, c1, k - j))
                if v < best:
                    best = v
            for y in range(c0 + 1, c1):
                v = max(f(r0, r1, c0, y, j), f(r0, r1, y, c1, k - j))
                if v < best:
                    best = v
        return best

    best_val = f(0, n1, 0, n2, m)

    def backtrack(r0, r1, c0, c1, k) -> list[Rect]:
        if k == 1:
            return [Rect(r0, r1, c0, c1)]
        target = f(r0, r1, c0, c1, k)
        if float(rect_load(gamma, r0, r1, c0, c1)) == 0.0:
            # all-zero region: chop arbitrarily along any splittable dim
            if r1 - r0 >= 2:
                x = r0 + 1
                return (backtrack(r0, x, c0, c1, 1)
                        + backtrack(x, r1, c0, c1, k - 1))
            if c1 - c0 >= 2:
                y = c0 + 1
                return (backtrack(r0, r1, c0, y, 1)
                        + backtrack(r0, r1, y, c1, k - 1))
            return [Rect(r0, r1, c0, c1)]  # cannot split an 1x1 further
        for j in range(1, k):
            for x in range(r0 + 1, r1):
                if max(f(r0, x, c0, c1, j), f(x, r1, c0, c1, k - j)) \
                        <= target + 1e-9:
                    return (backtrack(r0, x, c0, c1, j)
                            + backtrack(x, r1, c0, c1, k - j))
            for y in range(c0 + 1, c1):
                if max(f(r0, r1, c0, y, j), f(r0, r1, y, c1, k - j)) \
                        <= target + 1e-9:
                    return (backtrack(r0, r1, c0, y, j)
                            + backtrack(r0, r1, y, c1, k - j))
        return [Rect(r0, r1, c0, c1)]  # k > 1 but unsplittable (1x1)

    rects = backtrack(0, n1, 0, n2, m)
    f.cache_clear()
    return Partition(rects, (n1, n2))
