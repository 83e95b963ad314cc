"""Array-backed continuous-batching request queue (the serve hot path).

``serve.batcher`` plans over Python ``Request`` lists: every call re-sums
the whole queue into a fresh prefix array, so a replan after K arrivals
costs O(n) even though the bisection itself is warm-started.  At serving
scale (n ~ 10^5 live requests, a replan per scheduler tick) the prefix
rebuild *is* the planner.  This module keeps the queue as numpy state and
maintains an **incremental prefix structure** over the descending-length
order, so one replan costs O(K + m log n) after K arrivals/evictions:

``LengthPrefix``
    Token counts bucketed by length (key ``cap - length``, so ascending
    keys = descending lengths — the order ``plan(sort=True)`` partitions).
    Updates are vectorized ``np.add.at`` over the K changed lengths;
    queries answer exactly the three questions the 1D partitioners ask of
    a dense prefix array ``p``:

    - ``prefix_tokens(c)``   = ``p[c]`` (tokens of the ``c`` longest),
    - ``cut_below(X)``       = ``searchsorted(p, X, 'right') - 1``,
    - ``first_at_least(t)``  = ``searchsorted(p, t, 'left')``,

    each in O(block + log(cap/block)) without materializing ``p``.

The solvers (:func:`direct_cut`, :func:`probe`, :func:`optimal_cuts`)
replicate ``core.oned`` **decision for decision** — same float target
expressions, same greedy (including the remainder-fits early exit), same
bisection brackets, warm handling and closed-interval return quirk — so
on integer token counts the cuts are bit-identical to
``batcher.plan(sort=True)`` over the same multiset.  (Scalar halving and
the wide multi-candidate bisection agree exactly in integral mode: both
return the minimal feasible integer when any probed candidate was
feasible, and the original float ``hi`` otherwise — neither schedule
probes ``hi`` itself, so the ``lowered`` flags coincide.  The
capacity-aware float path matches to the engine's 1e-9 relative
tolerance, bit-identical when the dense path takes the scalar branch,
``n * m <= 2048``.)

Exactness domain: token totals below 2**53 (prefix values stay exactly
representable in the float64 comparisons both paths share); boundary
counts are fixed up with arbitrary-precision int-vs-float comparisons,
so no query result ever depends on a rounded subtraction.

The port's NumPy copy of ``repro.serve.queue``, decision for decision,
with one departure: ``cut_below`` follows the ``searchsorted`` contract
where no prefix entry qualifies (``X`` below 0, or at or below 0 with
``strict``), returning index -1 where the reference returns 0.  The
solvers never ask that question, so their cuts are the reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import search
from repro_torch.obs import trace as _trace
from repro_torch.obs.counters import C as _C

__all__ = ["DEFAULT_CAP", "LengthPrefix", "RequestQueue", "direct_cut",
           "first_at_least", "optimal_cuts", "probe"]

DEFAULT_CAP = 1 << 20  # max representable prompt length (tokens)


class LengthPrefix:
    """Incremental prefix sums over the descending-length request order.

    ``cap`` bounds representable lengths (``1 <= length <= cap``);
    ``block`` trades update cost (none) against query cost (one local
    cumsum per touched block, cached until the next mutation).
    """

    def __init__(self, cap: int = DEFAULT_CAP, block: int = 512):
        if cap % block or block <= 0:
            raise ValueError(f"cap ({cap}) must be a multiple of "
                             f"block ({block})")
        self.cap = int(cap)
        self.block = int(block)
        self._cnt = np.zeros(cap, dtype=np.int64)       # per length-key
        nb = cap // block
        self._blk_cnt = np.zeros(nb, dtype=np.int64)
        self._blk_tok = np.zeros(nb, dtype=np.int64)
        self._n = 0
        self._total = 0
        self._dirty = True
        self._bcc = self._btc = None   # block-level cumulative count/tokens
        self._bcache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def n(self) -> int:
        return self._n

    @property
    def total(self) -> int:
        return self._total

    def _keys(self, lengths) -> tuple[np.ndarray, np.ndarray]:
        ls = np.asarray(lengths)
        if ls.size and not np.issubdtype(ls.dtype, np.integer):
            raise TypeError(f"lengths must be integers, got {ls.dtype}")
        ls = ls.astype(np.int64, copy=False).ravel()
        if ls.size and (ls.min() < 1 or ls.max() > self.cap):
            raise ValueError(f"lengths must lie in [1, {self.cap}]")
        return self.cap - ls, ls

    def add(self, lengths) -> None:
        keys, ls = self._keys(lengths)
        if not ls.size:
            return
        np.add.at(self._cnt, keys, 1)
        blk = keys // self.block
        np.add.at(self._blk_cnt, blk, 1)
        np.add.at(self._blk_tok, blk, ls)
        self._n += ls.size
        self._total += int(ls.sum())
        self._dirty = True

    def remove(self, lengths) -> None:
        keys, ls = self._keys(lengths)
        if not ls.size:
            return
        np.subtract.at(self._cnt, keys, 1)
        if self._cnt[keys].min() < 0:
            np.add.at(self._cnt, keys, 1)  # undo before raising
            raise ValueError("removing lengths not present in the structure")
        blk = keys // self.block
        np.subtract.at(self._blk_cnt, blk, 1)
        np.subtract.at(self._blk_tok, blk, ls)
        self._n -= ls.size
        self._total -= int(ls.sum())
        self._dirty = True

    def _refresh(self) -> None:
        if self._dirty:
            self._bcc = np.cumsum(self._blk_cnt)
            self._btc = np.cumsum(self._blk_tok)
            self._bcache.clear()
            self._dirty = False

    def _block_cums(self, ib: int) -> tuple[np.ndarray, np.ndarray]:
        got = self._bcache.get(ib)
        if got is None:
            B = self.block
            sl = self._cnt[ib * B:(ib + 1) * B]
            lens = self.cap - np.arange(ib * B, (ib + 1) * B, dtype=np.int64)
            got = (np.cumsum(sl), np.cumsum(sl * lens))
            self._bcache[ib] = got
        return got

    def prefix_tokens(self, c: int) -> int:
        """``p[c]``: total tokens of the ``c`` longest queued requests."""
        self._refresh()
        c = int(c)
        if c <= 0:
            return 0
        if c >= self._n:
            return self._total
        ib = int(np.searchsorted(self._bcc, c, side="left"))
        base_c = int(self._bcc[ib - 1]) if ib else 0
        base_t = int(self._btc[ib - 1]) if ib else 0
        ccum, tcum = self._block_cums(ib)
        need = c - base_c
        j = int(np.searchsorted(ccum, need, side="left"))
        bc = int(ccum[j - 1]) if j else 0
        bt = int(tcum[j - 1]) if j else 0
        ell = self.cap - (ib * self.block + j)
        return base_t + bt + (need - bc) * ell

    def max_element(self) -> int:
        """Longest queued length (``maxel`` of the dense load array)."""
        if self._n == 0:
            return 0
        self._refresh()
        ib = int(np.searchsorted(self._bcc, 1, side="left"))
        ccum, _ = self._block_cums(ib)
        j = int(np.searchsorted(ccum, 1, side="left"))
        return self.cap - (ib * self.block + j)

    def cut_below(self, X, *, strict: bool = False) -> tuple[int, int]:
        """``(e, p[e])`` with the largest ``e`` s.t. ``p[e] <= X``
        (``< X`` when ``strict``) — ``searchsorted(p, X, side) - 1`` with
        the dense array's exact comparison semantics.  Where no entry
        qualifies (``X < 0``, or ``X <= 0`` when ``strict``) that is
        ``(-1, 0)``: index -1, and the empty prefix's 0 tokens.
        """
        self._refresh()
        if X <= 0 if strict else X < 0:
            return -1, 0
        if self._n == 0:
            return 0, 0
        if X > self._total or (not strict and X == self._total):
            return self._n, self._total
        # locate the crossing block/length-group with float arithmetic,
        # then repair the count with exact int-vs-float comparisons (the
        # estimate is off by at most a couple of elements).
        side = "left" if strict else "right"
        ib = int(np.searchsorted(self._btc, X, side=side))
        base_c = int(self._bcc[ib - 1]) if ib else 0
        base_t = int(self._btc[ib - 1]) if ib else 0
        ccum, tcum = self._block_cums(ib)
        rem = float(X) - base_t
        j = int(np.searchsorted(tcum, rem, side=side))
        bc = int(ccum[j - 1]) if j else 0
        bt = int(tcum[j - 1]) if j else 0
        gcnt = int(ccum[min(j, self.block - 1)]) - bc
        ell = self.cap - (ib * self.block + j)
        k = int(max(rem - bt, 0.0) // ell) if ell > 0 else 0
        e = base_c + bc + min(max(k, 0), gcnt)

        def fits(c: int) -> bool:
            t = self.prefix_tokens(c)
            return t < X if strict else t <= X

        while e > 0 and not fits(e):
            e -= 1
        while e < self._n and fits(e + 1):
            e += 1
        return e, self.prefix_tokens(e)

    def first_at_least(self, t) -> int:
        """``searchsorted(p, t, 'left')``: smallest ``e`` with
        ``p[e] >= t`` (``n + 1`` when ``t`` exceeds the total, exactly as
        on the dense length-``n+1`` array — callers clip)."""
        if t <= 0:
            return 0
        e, _ = self.cut_below(t, strict=True)
        return e + 1


# ---------------------------------------------------------------------------
# Incremental twins of the ``core.oned`` 1D solvers


def first_at_least(pf: LengthPrefix, t) -> int:
    return pf.first_at_least(t)


def direct_cut(pf: LengthPrefix, m: int, speeds=None) -> np.ndarray:
    """DirectCut over the incremental prefix — bit-identical to
    ``oned.direct_cut`` (or ``batcher._direct_cut_speeds``) on the dense
    descending-length prefix array."""
    n = pf.n
    cuts = np.empty(m + 1, dtype=np.int64)
    cuts[0], cuts[m] = 0, n
    sp = search.normalize_speeds(speeds, m)
    if sp is None:
        targets = float(pf.total) / m * np.arange(1, m, dtype=np.float64)
        cuts[1:m] = [pf.first_at_least(t) for t in targets]
        np.clip(cuts, 0, n, out=cuts)
        return cuts
    targets = float(pf.total) * np.cumsum(sp[:-1]) / float(sp.sum())
    cuts[1:m] = [min(pf.first_at_least(t), n) for t in targets]
    np.maximum.accumulate(cuts, out=cuts)
    return cuts


def probe(pf: LengthPrefix, m: int, L: float,
          speeds: np.ndarray | None = None) -> np.ndarray | None:
    """``oned.probe`` on the incremental prefix: same greedy, same
    remainder-fits early exit, same dead-processor skipping."""
    _C.scalar_probes += 1
    n, total = pf.n, pf.total
    cuts = np.empty(m + 1, dtype=np.int64)
    cuts[0] = 0
    b, Db = 0, 0
    if speeds is not None:
        for i in range(1, m + 1):
            cap = L * float(speeds[i - 1])
            if cap > 0:
                e, De = pf.cut_below(Db + cap)
                if e > b:
                    b, Db = e, De
            cuts[i] = b
        return cuts if b >= n else None
    for i in range(1, m + 1):
        if total - Db <= L:  # remainder fits in one interval
            cuts[i:] = [b] * (m - i) + [n]
            return cuts
        e, De = pf.cut_below(Db + L)
        if e <= b:
            return None  # single element exceeds L
        cuts[i] = e
        b, Db = e, De
    return None if b < n else cuts


def optimal_cuts(pf: LengthPrefix, m: int, *, warm: float | None = None,
                 speeds=None) -> np.ndarray:
    """Exact bottleneck cuts, replicating ``oned.probe_bisect_optimal``'s
    brackets, warm handling and closed-interval return value (token loads
    are integers, so the integral halving is exact)."""
    n = pf.n
    if n == 0:
        return np.zeros(m + 1, dtype=np.int64)
    sp = search.normalize_speeds(speeds, m) if pf.total > 0 else None
    if sp is not None:
        return _optimal_hetero(pf, m, sp, warm)
    total, maxel = pf.total, pf.max_element()
    lo = max(float(total) / m, float(maxel))
    hi = float(total) / m + float(maxel)
    if warm is not None and lo < warm < hi:
        if probe(pf, m, float(warm)) is not None:
            hi = float(warm)
        else:
            lo = np.floor(warm) + 1
    L = search.bisect_bottleneck_scalar(
        lambda Lc: probe(pf, m, Lc) is not None, lo, hi, integral=True)
    return search.realize(lambda Lc: probe(pf, m, Lc), L, integral=True)


def _optimal_hetero(pf: LengthPrefix, m: int, speeds: np.ndarray,
                    warm: float | None) -> np.ndarray:
    total = float(pf.total)
    maxel = float(pf.max_element())
    smax = float(speeds.max())
    lo = max(total / float(speeds.sum()), maxel / smax)
    hi = (total / smax) * (1 + 1e-9) + 1e-12
    if warm is not None and lo < warm < hi:
        if probe(pf, m, float(warm), speeds) is not None:
            hi = float(warm)
        else:
            lo = float(warm)
    L = search.bisect_bottleneck_scalar(
        lambda Lc: probe(pf, m, Lc, speeds) is not None,
        lo, hi, integral=False)
    return search.realize(lambda Lc: probe(pf, m, Lc, speeds), L,
                          integral=False)


# ---------------------------------------------------------------------------
# The queue itself


class RequestQueue:
    """Live request state as parallel arrays in descending-remaining order.

    Columns: ``rem`` (remaining tokens — the partition load), ``tokens``
    (original prompt length), ``arrival`` (time), ``rid``, ``replica``
    (current owner, ``-1`` = not yet assigned).  The descending order is
    the one ``batcher.plan(sort=True)`` partitions, so a cut array from
    the incremental solvers maps straight onto contiguous ranges.

    Admission inserts sorted batches (O(n + K) memmove, no re-sort);
    :meth:`serve` consumes per-replica token budgets front-to-back and
    repositions at most one partially-served request per replica.
    """

    _COLS = ("rem", "tokens", "arrival", "rid", "replica")

    def __init__(self, *, cap: int = DEFAULT_CAP, block: int = 512):
        self.prefix = LengthPrefix(cap=cap, block=block)
        self.rem = np.empty(0, dtype=np.int64)
        self.tokens = np.empty(0, dtype=np.int64)
        self.arrival = np.empty(0, dtype=np.float64)
        self.rid = np.empty(0, dtype=np.int64)
        self.replica = np.empty(0, dtype=np.int64)
        self._next_rid = 0

    @property
    def n(self) -> int:
        return self.rem.size

    @property
    def total_remaining(self) -> int:
        return self.prefix.total

    def admit(self, tokens, arrival_times=None) -> np.ndarray:
        """Admit a batch; returns the assigned rids (input order)."""
        toks = np.asarray(tokens, dtype=np.int64).ravel()
        k = toks.size
        if k == 0:
            return np.empty(0, dtype=np.int64)
        at = np.zeros(k) if arrival_times is None \
            else np.broadcast_to(np.asarray(arrival_times, float), (k,))
        self.prefix.add(toks)
        rids = np.arange(self._next_rid, self._next_rid + k, dtype=np.int64)
        self._next_rid += k
        order = np.argsort(-toks, kind="stable")
        pos = np.searchsorted(-self.rem, -toks[order], side="right")
        self.rem = np.insert(self.rem, pos, toks[order])
        self.tokens = np.insert(self.tokens, pos, toks[order])
        self.arrival = np.insert(self.arrival, pos, at[order])
        self.rid = np.insert(self.rid, pos, rids[order])
        self.replica = np.insert(self.replica, pos,
                                 np.full(k, -1, dtype=np.int64))
        if self.n > _C.serve_queue_peak:
            _C.serve_queue_peak = self.n
        return rids

    # -- planning ----------------------------------------------------------

    def plan_cuts(self, n_replicas: int, *, algo: str = "optimal",
                  warm: float | None = None, speeds=None) -> np.ndarray:
        """Cut array over the current descending-remaining order; same
        contract (and cuts) as ``batcher.plan`` on the same multiset."""
        _C.serve_plans += 1
        with _trace.span("serve.plan", algo=algo, queue_depth=self.n,
                         replicas=n_replicas, incremental=True):
            if algo == "direct":
                return direct_cut(self.prefix, n_replicas, speeds=speeds)
            if algo != "optimal":
                raise ValueError(f"incremental planner supports 'optimal' "
                                 f"and 'direct', got {algo!r}")
            return optimal_cuts(self.prefix, n_replicas, warm=warm,
                                speeds=speeds)

    def assign_contiguous(self, cuts: np.ndarray) -> None:
        """Adopt a cut array: range i belongs to replica i."""
        cuts = np.asarray(cuts)
        self.replica = np.repeat(
            np.arange(cuts.size - 1, dtype=np.int64), np.diff(cuts))

    def extend_greedy(self, n_replicas: int, speeds=None) -> None:
        """Keep-path assignment: owned requests stay put; unassigned ones
        go LPT onto the least (relatively) loaded replica — the array twin
        of ``batcher._greedy_extend``."""
        import heapq
        loads = self.loads(n_replicas)
        sp = search.normalize_speeds(speeds, n_replicas)
        heap = []
        for i in range(n_replicas):
            if sp is not None and sp[i] <= 0:
                continue  # dead replica: receives nothing
            heap.append((loads[i] / (1.0 if sp is None else sp[i]), i))
        if not heap:
            raise ValueError("all replicas dead (speeds all zero)")
        heapq.heapify(heap)
        idx = np.flatnonzero(self.replica < 0)  # already desc by rem
        for i in idx:
            key, r = heapq.heappop(heap)
            self.replica[i] = r
            add = float(self.rem[i]) / (1.0 if sp is None else sp[r])
            heapq.heappush(heap, (key + add, r))

    def loads(self, n_replicas: int) -> np.ndarray:
        """Per-replica remaining-token loads (unassigned excluded)."""
        owned = self.replica >= 0
        return np.bincount(self.replica[owned],
                           weights=self.rem[owned].astype(np.float64),
                           minlength=n_replicas)

    # -- serving -----------------------------------------------------------

    def serve(self, budgets, *, now: float, dt: float
              ) -> tuple[np.ndarray, np.ndarray]:
        """Consume per-replica token budgets over the tick ``[now, now+dt)``.

        Each replica serves its range shortest-remaining-first (the range
        is descending, so back-to-front) at rate ``budget / dt``;
        completion times interpolate inside the tick.  Returns
        ``(rids, latencies)`` of completed requests.  Shortest-first is
        the latency-optimal single-replica discipline and keeps requests
        *completing* under overload (largest-first would fair-share the
        budget across the biggest requests and finish none of them); the
        starvation risk it shifts onto the longest requests is what
        ``deadline`` eviction and the policy-graded replans manage.  At
        most one request per replica ends the tick partially served; its
        shrunken remaining count is repositioned to keep the global order
        sorted.
        """
        budgets = np.asarray(budgets, dtype=np.int64)
        empty = (np.empty(0, dtype=np.int64), np.empty(0))
        if self.n == 0 or not budgets.any():
            return empty
        order = np.argsort(self.replica, kind="stable")
        rep_sorted = self.replica[order]
        done_idx, done_lat = [], []
        part_idx, part_new = [], []
        for r in range(budgets.size):
            B = int(budgets[r])
            s = int(np.searchsorted(rep_sorted, r, side="left"))
            e = int(np.searchsorted(rep_sorted, r, side="right"))
            if B <= 0 or s == e:
                continue
            idx = order[s:e][::-1]  # ascending remaining: shortest first
            cums = np.cumsum(self.rem[idx])
            k = int(np.searchsorted(cums, B, side="right"))
            if k > 0:
                fin = idx[:k]
                done_idx.append(fin)
                done_lat.append(now + (cums[:k] / B) * dt
                                - self.arrival[fin])
            if k < idx.size:
                left = B - (int(cums[k - 1]) if k else 0)
                if left > 0:
                    part_idx.append(int(idx[k]))
                    part_new.append(int(self.rem[idx[k]]) - left)
        if not done_idx and not part_idx:
            return empty
        comp = np.concatenate(done_idx) if done_idx \
            else np.empty(0, dtype=np.int64)
        lats = np.concatenate(done_lat) if done_idx else np.empty(0)
        rids = self.rid[comp].copy()
        if comp.size:
            self.prefix.remove(self.rem[comp])
        pidx = np.asarray(part_idx, dtype=np.int64)
        pnew = np.asarray(part_new, dtype=np.int64)
        if pidx.size:
            self.prefix.remove(self.rem[pidx])
            self.prefix.add(pnew)
        keep = np.ones(self.n, dtype=bool)
        keep[comp] = False
        if pidx.size:
            pidx = pidx - np.cumsum(~keep)[pidx]  # post-delete positions
        self._delete(~keep)
        if pidx.size:
            self._reposition(pidx, pnew)
        _C.serve_completed += rids.size
        return rids, lats

    def evict_indices(self, idx: np.ndarray) -> np.ndarray:
        """Drop rows by position (deadline eviction); returns their rids."""
        idx = np.asarray(idx, dtype=np.int64)
        if not idx.size:
            return np.empty(0, dtype=np.int64)
        rids = self.rid[idx].copy()
        self.prefix.remove(self.rem[idx])
        drop = np.zeros(self.n, dtype=bool)
        drop[idx] = True
        self._delete(drop)
        return rids

    def _delete(self, drop: np.ndarray) -> None:
        if drop.any():
            keep = ~drop
            for c in self._COLS:
                setattr(self, c, getattr(self, c)[keep])

    def _reposition(self, idx: np.ndarray, new_rem: np.ndarray) -> None:
        """Re-sort the (few) rows whose ``rem`` shrank, via delete+insert."""
        vals = {c: getattr(self, c)[idx] for c in self._COLS}
        vals["rem"] = new_rem
        for c in self._COLS:
            setattr(self, c, np.delete(getattr(self, c), idx))
        order = np.argsort(-new_rem, kind="stable")
        pos = np.searchsorted(-self.rem, -new_rem[order], side="right")
        for c in self._COLS:
            setattr(self, c, np.insert(getattr(self, c), pos,
                                       vals[c][order]))

    # -- interop -----------------------------------------------------------

    def as_requests(self) -> list:
        """The queue as ``batcher.Request`` objects (descending order) —
        the bridge to the list-based planner for equivalence checks."""
        from . import batcher
        return [batcher.Request(int(r), int(t))
                for r, t in zip(self.rid, self.rem)]

    def check(self) -> None:
        """Invariant check (tests): sorted order + prefix consistency."""
        assert (np.diff(self.rem) <= 0).all(), "rem not descending"
        assert self.prefix.n == self.n
        assert self.prefix.total == int(self.rem.sum())
        dense = np.concatenate([[0], np.cumsum(self.rem)])
        probe_at = np.linspace(0, self.n, num=min(self.n + 1, 17),
                               dtype=np.int64)
        for c in probe_at:
            assert self.prefix.prefix_tokens(int(c)) == int(dense[c])
