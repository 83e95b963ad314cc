"""Zero-copy stripe prefix views + memoized stripe costs over Gamma.

The port's NumPy copy of ``repro.core.stripecache``: the same code in the
same order of floating-point operations, so its results are bit-identical.

The jagged DPs (`jag_pq_opt`, `jag_m_alloc`, `jag_m_opt`), the hierarchical
bisections and the two-phase HYBRID pipeline evaluate thousands of stripes
``[r0, r1)`` inside nested binary searches; the seed re-materialized a fresh
O(n2) prefix array (``gamma[r1] - gamma[r0]``) for every probe step.  Two
classes centralize that access:

:class:`StripeView` — full-width stripes of one Gamma (one orientation):

- ``prefix``        writes the difference into one reused buffer — zero
                    allocations per probe step (callers must consume the
                    buffer before the next ``prefix`` call);
- ``stripe_matrix`` (module-level) gathers many stripes at once into a
                    single fresh ``(R, n+1)`` matrix — one fancy-index op,
                    for the packed multi-chain probes;
- ``cost``          memoizes the exact q-way bottleneck per ``(r0, r1, q)``
                    so DP cells shared between the binary search and the
                    backtrack are computed once.

:class:`SubgridView` — the windowed generalization: a zero-copy sub-Gamma
window ``[r0, r1) x [c0, c1)`` over one *parent* Gamma.  Every window of
the same parent shares one cost/cuts memo **keyed in parent coordinates**,
so a stripe cost computed while evaluating one candidate partition (one
phase-1 ``P``, one fast phase-2 pass) is reused by every later window that
covers the same rows and columns — the sharing HYBRID's expected-LI scan
and fast/slow refinement loop are built on.  No sub-Gamma is ever
materialized: stripe prefixes of a window are row differences of the
parent restricted to the window's columns, rebased so ``p[0] == 0``.

``axis=1`` (StripeView) serves the transposed orientation without copying
Gamma: rows of ``gamma.T`` are strided views, and ``prefix`` lands them in
the contiguous buffer searchsorted wants.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.counters import C as _C

from . import oned
from .types import Rect

__all__ = ["StripeView", "SubgridView", "stripe_matrix"]


def stripe_matrix(gamma: np.ndarray, r0s, r1s) -> np.ndarray:
    """``(R, n+1)`` matrix of stripe prefixes ``[r0s[i], r1s[i])`` in one
    gather — the shared bulk form of ``prefix.stripe_col_prefix`` used by
    the packed multi-chain probes (jagged, rect)."""
    return gamma.take(r1s, axis=0) - gamma.take(r0s, axis=0)


class StripeView:
    """Cached stripe-prefix access for one Gamma (and one orientation)."""

    def __init__(self, gamma: np.ndarray, axis: int = 0):
        self.gamma = gamma if axis == 0 else gamma.T
        self._buf = np.empty(self.gamma.shape[1], dtype=gamma.dtype)
        self._costs: dict[tuple[int, int, int], float] = {}

    def prefix(self, r0: int, r1: int) -> np.ndarray:
        """Stripe column-prefix array, written into the shared buffer.

        The returned array is reused by the next call — consume it first.
        """
        return np.subtract(self.gamma[r1], self.gamma[r0], out=self._buf)

    def prefix_copy(self, r0: int, r1: int) -> np.ndarray:
        """Owned copy, for callers that must hold the stripe."""
        return self.gamma[r1] - self.gamma[r0]

    def count(self, r0: int, r1: int, L, cap: int) -> int:
        """Greedy interval count of the stripe for bottleneck L (capped)."""
        return oned.probe_count(self.prefix(r0, r1), L, cap)

    def cost(self, r0: int, r1: int, q: int) -> float:
        """Exact optimal q-way bottleneck of stripe ``[r0, r1)``, memoized."""
        key = (r0, r1, q)
        _C.stripe_lookups += 1
        v = self._costs.get(key)
        if v is None:
            _C.stripe_misses += 1
            p = self.prefix_copy(r0, r1)
            v = oned.max_interval_load(p, oned.optimal_1d(p, q))
            self._costs[key] = v
        else:
            _C.stripe_hits += 1
        return v


class SubgridView:
    """Zero-copy window ``[r0, r1) x [c0, c1)`` over one parent Gamma.

    Construct the root with ``SubgridView(gamma)`` and carve windows with
    :meth:`window`; all windows of one parent share

    - the parent Gamma (never copied),
    - one ``(r0, r1, c0, c1, q) -> (cost, cuts)`` memo in parent
      coordinates (the cross-window stripe-cost sharing),
    - a lazy pair of orientation :class:`StripeView` buffers
      (:meth:`dim_prefix`, the hierarchical bisection's access pattern),
    - a lazy transposed root (:meth:`transposed`) whose windows share a
      memo of their own — the 'best'-orientation DPs run both sides
      without re-deriving either.

    All stripe accessors below take *window-relative* row indices and
    return prefix arrays rebased to ``p[0] == 0`` (the engine's 1D
    partitioners read ``p[-1]`` as the total).
    """

    def __init__(self, gamma: np.ndarray, r0: int = 0, r1: int | None = None,
                 c0: int = 0, c1: int | None = None, *, _root=None):
        self.gamma = gamma
        self.r0, self.c0 = r0, c0
        self.r1 = gamma.shape[0] - 1 if r1 is None else r1
        self.c1 = gamma.shape[1] - 1 if c1 is None else c1
        root = self if _root is None else _root
        self._root = root
        if _root is None:
            self._costs: dict[tuple, tuple[float, np.ndarray]] = {}
            self._svs = None      # lazy (axis-0, axis-1) StripeView pair
            self._troot = None    # lazy transposed root SubgridView
        else:
            self._costs = root._costs

    # -- construction -------------------------------------------------------

    def window(self, rect: Rect) -> "SubgridView":
        """Child window for ``rect`` (parent coordinates), sharing the memo."""
        return SubgridView(self.gamma, rect.r0, rect.r1, rect.c0, rect.c1,
                           _root=self._root)

    def transposed(self) -> "SubgridView":
        """This window over the transposed parent (memo shared across all
        transposed windows of the same root)."""
        root = self._root
        if root._troot is None:
            root._troot = SubgridView(np.ascontiguousarray(root.gamma.T))
        return SubgridView(root._troot.gamma, self.c0, self.c1,
                           self.r0, self.r1, _root=root._troot)

    # -- geometry -----------------------------------------------------------

    @property
    def n1(self) -> int:
        return self.r1 - self.r0

    @property
    def n2(self) -> int:
        return self.c1 - self.c0

    @property
    def total(self):
        g = self.gamma
        return (g[self.r1, self.c1] - g[self.r0, self.c1]
                - g[self.r1, self.c0] + g[self.r0, self.c0])

    @property
    def integral(self) -> bool:
        return bool(np.issubdtype(self.gamma.dtype, np.integer))

    # -- prefixes (window-relative indices, rebased arrays) ----------------

    def row_prefix(self) -> np.ndarray:
        """``(n1+1,)`` prefix of the window's row projection."""
        col = self.gamma[self.r0:self.r1 + 1, self.c1] \
            - self.gamma[self.r0:self.r1 + 1, self.c0]
        return col - col[0]

    def stripe_prefix(self, a: int, b: int) -> np.ndarray:
        """``(n2+1,)`` column prefix of window rows ``[a, b)`` (owned)."""
        g = self.gamma
        p = g[self.r0 + b, self.c0:self.c1 + 1] \
            - g[self.r0 + a, self.c0:self.c1 + 1]
        return p - p[0]

    def stripe_matrix(self, cuts) -> np.ndarray:
        """``(S, n2+1)`` stripes between consecutive ``cuts`` in one gather."""
        rc = np.asarray(cuts, dtype=np.int64) + self.r0
        g = self.gamma[:, self.c0:self.c1 + 1]
        sm = g.take(rc[1:], axis=0) - g.take(rc[:-1], axis=0)
        return sm - sm[:, :1]

    # -- memoized 1D solves (parent-coordinate keys) ------------------------

    def _key(self, a: int, b: int, q: int) -> tuple:
        return (self.r0 + a, self.r0 + b, self.c0, self.c1, int(q))

    def cost(self, a: int, b: int, q: int, *, warm: float | None = None
             ) -> float:
        """Exact optimal q-way bottleneck of window stripe ``[a, b)``.

        ``warm`` seeds the bisection (one probe turns a prior bottleneck
        into a tightened bound); it never changes the integer optimum, so
        the memo is keyed without it.
        """
        return self.cuts_1d(a, b, q, warm=warm)[0]

    def cuts_1d(self, a: int, b: int, q: int, *,
                warm: float | None = None) -> tuple[float, np.ndarray]:
        """Memoized ``(cost, cuts)`` of the optimal q-way stripe split."""
        key = self._key(a, b, q)
        _C.subgrid_lookups += 1
        v = self._costs.get(key)
        if v is None:
            _C.subgrid_misses += 1
            p = self.stripe_prefix(a, b)
            cuts = oned.optimal_1d(p, q, warm=warm)
            v = (oned.max_interval_load(p, cuts), cuts)
            self._costs[key] = v
            if len(self._costs) > _C.subgrid_memo_peak:
                _C.subgrid_memo_peak = len(self._costs)
        else:
            _C.subgrid_hits += 1
        return v

    def cuts_1d_batch(self, jobs) -> list[tuple[float, np.ndarray]]:
        """Batch form of :meth:`cuts_1d`: ``jobs`` is a list of ``(a, b, q)``
        window stripes; uncached jobs are solved through ONE packed
        multi-chain probe (``oned.optimal_1d_batch``) and memoized."""
        jobs = list(jobs)
        miss = [j for j in dict.fromkeys(jobs)
                if self._key(*j) not in self._costs]
        # each job is one lookup; a duplicate of an uncached job counts as
        # a hit — it reads the entry its twin just filled
        _C.subgrid_lookups += len(jobs)
        _C.subgrid_misses += len(miss)
        _C.subgrid_hits += len(jobs) - len(miss)
        if miss:
            ps = [self.stripe_prefix(a, b) for a, b, _ in miss]
            for (a, b, q), p, cuts in zip(
                    miss, ps, oned.optimal_1d_batch(ps, [q for _, _, q
                                                         in miss])):
                self._costs[self._key(a, b, q)] = \
                    (oned.max_interval_load(p, cuts), cuts)
            if len(self._costs) > _C.subgrid_memo_peak:
                _C.subgrid_memo_peak = len(self._costs)
        return [self._costs[self._key(*j)] for j in jobs]

    # -- hier-style full-length prefixes (parent coordinates) ---------------

    def dim_prefix(self, r: Rect, dim: int) -> tuple[int, int, np.ndarray]:
        """(lo, hi, prefix array along ``dim``) for cutting rect ``r``.

        Parent-coordinate twin of the stripe accessors: the returned array
        spans the *full* parent extent of ``dim`` (indexable by global cut
        positions) restricted to ``r`` in the other dimension, and lives in
        a shared per-orientation buffer — consume before the next call.
        """
        root = self._root
        if root._svs is None:
            root._svs = (StripeView(root.gamma, axis=0),
                         StripeView(root.gamma, axis=1))
        sv_row, sv_col = root._svs
        if dim == 0:  # cut rows: prefix over rows restricted to r's columns
            return r.r0, r.r1, sv_col.prefix(r.c0, r.c1)
        return r.c0, r.c1, sv_row.prefix(r.r0, r.r1)
