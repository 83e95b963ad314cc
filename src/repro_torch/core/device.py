"""On-device partitioners: the port of ``repro.core.device`` (2D paths of
the frame planner).

The reference writes each solver for one Gamma and batches it with
``vmap``; its loops are ``lax.scan`` / ``lax.while_loop``.  Here every
function carries its batch axes explicitly — frames, stripes and
candidate bottlenecks — and the loops are Python loops over those batched
tensors, never over frames:

- fixed-length scans (the ``m``-step probes, the ``rounds`` of
  :func:`wide_bisect_device`) run their fixed count with no host sync;
- the exact integer bisections (:func:`wide_bisect_exact_device`,
  :func:`_wide_bisect_exact_batch`) read one flag per round (``.item()``)
  over all lanes and stop when every lane has converged — the
  reference's batched ``while_loop`` does the same.

Two partitioners are ported:

- :func:`jag_m_heur_device_impl`, the paper's JAG-M-HEUR (the planner's
  default) on float32 accumulators: results are bit-identical to the
  reference where every frame total is below 2**24;
- :func:`jag_pq_opt_device_impl`, the exact JAG-PQ-OPT on int32 Gamma
  (total load below 2**30), bit-identical to the reference; its per-stripe
  column probes run through the probe kernel (``kernels.probe``).

The reference's ``speeds=`` (capacity-aware) and float-exact branches and
JAG-M-OPT are not ported yet; asking for them raises
``NotImplementedError``.  The greedy steps (:func:`_advance`,
:func:`_stripe_fits`) are ``torch.searchsorted`` on the current device.

Positions are int64 inside (``gather`` indexes with int64); returned cuts
and counts are int32, like the reference's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.probe import ops as probe_ops

_INT_LIMIT = 2 ** 30

# ---------------------------------------------------------------------------
# probes


def _advance(p: torch.Tensor, pos: torch.Tensor,
             L: torch.Tensor) -> torch.Tensor:
    """One greedy step on every lane: furthest e with p[e] <= p[pos] + L,
    never behind pos.  p: (..., N+1) rows; pos, L: (..., K)."""
    target = p.gather(-1, pos) + L
    nxt = torch.searchsorted(p, target, right=True) - 1
    nxt = nxt.clamp_max(p.shape[-1] - 1)
    return torch.maximum(nxt, pos)  # stuck (single element > L) stays stuck


def probe_device(p: torch.Tensor, m: int, Ls: torch.Tensor) -> torch.Tensor:
    """Feasibility of each candidate bottleneck: p (B, N+1), Ls (B, K)
    -> (B, K) bool."""
    pos = torch.zeros(Ls.shape, dtype=torch.int64, device=p.device)
    for _ in range(m):
        pos = _advance(p, pos, Ls)
    return pos == p.shape[-1] - 1


def probe_cuts_device(p: torch.Tensor, m: int,
                      L: torch.Tensor) -> torch.Tensor:
    """Cut arrays (B, m+1) realizing bottleneck L (B,) (garbage where L is
    infeasible)."""
    pos = torch.zeros((p.shape[0], 1), dtype=torch.int64, device=p.device)
    cuts = [pos]
    for _ in range(m):
        pos = _advance(p, pos, L[:, None])
        cuts.append(pos)
    return torch.cat(cuts, dim=1).to(torch.int32)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors, rounded once.

    The reference's candidate schedule ``lo + (hi - lo) * fr`` is compiled
    by XLA into a fused multiply-add, so this is the arithmetic the port
    must repeat bit for bit, on the CPU and on the card alike.  The float64
    product of two float32 values is exact; the float64 sum is made
    round-to-odd from its exact error (two-sum), and a round-to-odd value
    with 29 spare bits rounds to the correctly rounded float32.
    """
    prod = a.double() * b.double()
    cd = c.double()
    s = prod + cd
    bb = s - prod
    err = (prod - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def wide_bisect_device(feasible, lo: torch.Tensor, hi: torch.Tensor, *,
                       k: int = 8, rounds: int = 8):
    """K candidates per round over B independent float32 intervals.

    ``feasible(Ls)`` maps an ascending (B, k) candidate matrix to a (B, k)
    bool mask (monotone).  Returns the final (lo, hi), each (B,); hi
    converges to the optimum from above, within (hi0-lo0)/(k+1)^rounds.
    Runs exactly ``rounds`` rounds with no host sync.
    """
    if lo.dtype != torch.float32:
        raise NotImplementedError(
            f"wide_bisect_device is ported for float32 accumulators, got "
            f"{lo.dtype}")
    fr = torch.arange(1, k + 1, dtype=lo.dtype, device=lo.device) / (k + 1)
    for _ in range(rounds):
        Ls = _fma_f32((hi - lo)[:, None], fr[None, :], lo[:, None])
        feas = feasible(Ls)
        # new hi: smallest feasible candidate (or old hi)
        hi_new = torch.where(feas, Ls, hi[:, None]).amin(dim=1)
        # new lo: largest infeasible candidate (or old lo)
        lo_new = torch.where(~feas, Ls, lo[:, None]).amax(dim=1)
        lo, hi = torch.minimum(lo_new, hi_new), hi_new
    return lo, hi


def optimal_1d_device(p: torch.Tensor, m: int, *, k: int = 8,
                      rounds: int = 8):
    """Optimal 1D partitions of B float32 prefix rows (B, N+1) by wide
    bisection.  Returns (cuts (B, m+1), bottleneck (B,))."""
    n = p.shape[-1] - 1
    total = p[:, n]
    el_max = torch.diff(p, dim=-1).amax(dim=-1)
    lo = torch.maximum(total / m, el_max)  # infeasible-or-optimal
    hi = total / m + el_max                # always feasible (DirectCut bound)
    _, hi = wide_bisect_device(lambda Ls: probe_device(p, m, Ls), lo, hi,
                               k=k, rounds=rounds)
    return probe_cuts_device(p, m, hi), hi


# ---------------------------------------------------------------------------
# masked per-stripe probe (variable processor counts, static shapes)


def _probe_cuts_masked(p: torch.Tensor, m_max: int, count: torch.Tensor,
                       L: torch.Tensor) -> torch.Tensor:
    """Cuts using only ``count`` intervals; the rest collapse at n.

    p (B, N+1), count (B,), L (B, K) -> (B, K, m_max+1) int64.
    """
    n = p.shape[-1] - 1
    pos = torch.zeros(L.shape, dtype=torch.int64, device=p.device)
    cnt = count[:, None]
    cuts = [pos]
    for i in range(m_max):
        nxt = torch.where(i < cnt, _advance(p, pos, L), pos)
        pos = torch.where(cnt - 1 == i, n, nxt)  # last live interval: to end
        cuts.append(pos)
    return torch.stack(cuts, dim=-1)


def _stripe_bottleneck(p: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Largest interval load of each cut array: p (B, N+1), cuts
    (B, K, C) -> (B, K)."""
    pe = p[:, None, :].expand(cuts.shape[:2] + p.shape[-1:])
    return (pe.gather(-1, cuts[..., 1:])
            - pe.gather(-1, cuts[..., :-1])).amax(dim=-1)


def _as_batch(gamma: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if gamma.ndim == 2:
        return gamma[None], True
    if gamma.ndim == 3:
        return gamma, False
    raise ValueError(f"expected a Gamma (n1+1, n2+1) or (T, n1+1, n2+1), got "
                     f"{tuple(gamma.shape)}")


def _unbatch(out: tuple, squeeze: bool) -> tuple:
    return tuple(x[0] for x in out) if squeeze else out


def jag_m_heur_device_impl(gamma: torch.Tensor, *, P: int, m: int,
                           k: int = 8, rounds: int = 8, gamma_dtype=None):
    """JAG-M-HEUR on device for a Gamma or a (T, n1+1, n2+1) stack.

    gamma_dtype: the bisection accumulators' dtype (row and stripe prefix
    arrays); only float32 is ported, which is also the default.  f32 ulps
    exceed 1 above 2**24, so results there may differ from the reference's
    in the last places of Gamma.
    Returns (row_cuts (T, P+1), counts (T, P), col_cuts (T, P, m_max+1),
    Lmax (T,)) with m_max = m - P + 1 (a stripe can never get more than
    that, since every other stripe keeps at least one processor); a 2D
    Gamma gives the same without the T axis.
    """
    gd = torch.float32 if gamma_dtype is None else gamma_dtype
    if gd != torch.float32:
        raise NotImplementedError(
            f"jag_m_heur_device_impl is ported for float32 accumulators, "
            f"got {gd}")
    g, squeeze = _as_batch(gamma)
    T, n2 = g.shape[0], g.shape[2] - 1
    row_prefix = g[:, :, n2].to(gd).contiguous()         # (T, n1+1)
    row_cuts, _ = optimal_1d_device(row_prefix, P, k=k, rounds=rounds)

    t = torch.arange(T, device=g.device)[:, None]
    rc = row_cuts.long()
    stripe_prefix = (g[t, rc[:, 1:]] - g[t, rc[:, :-1]]).to(gd)  # (T, P, n2+1)
    loads = stripe_prefix[..., n2]
    total = row_prefix[:, -1].clamp_min(1)

    # paper's proportional allocation: ceil((m - P) * load / total), >= 1
    counts = torch.ceil((m - P) * loads / total[:, None]).to(torch.int32)
    counts = counts.clamp_min(1)
    for _ in range(P):
        s = torch.argmax(loads / counts, dim=1, keepdim=True)
        give = (counts.sum(dim=1, keepdim=True) < m).to(torch.int32)
        counts = counts.scatter_add(1, s, give)

    m_max = m - P + 1
    p = stripe_prefix.reshape(T * P, n2 + 1)
    cnt = counts.reshape(T * P)
    total_s = p[:, n2]
    el = torch.diff(p, dim=-1).amax(dim=-1)
    lo = torch.maximum(total_s / cnt, el)
    hi = total_s / cnt + el

    def feasible(Ls):
        cuts = _probe_cuts_masked(p, m_max, cnt, Ls)
        return _stripe_bottleneck(p, cuts) <= Ls

    _, hi_f = wide_bisect_device(feasible, lo, hi, k=k, rounds=rounds)
    cuts = _probe_cuts_masked(p, m_max, cnt, hi_f[:, None])
    bots = _stripe_bottleneck(p, cuts)[:, 0].reshape(T, P)
    col_cuts = cuts[:, 0].reshape(T, P, m_max + 1).to(torch.int32)
    return _unbatch((row_cuts, counts, col_cuts, bots.amax(dim=1)), squeeze)


# ---------------------------------------------------------------------------
# exact wide bisection (runs until every interval closes)


def _interior_candidates(lo, hi, j, k: int):
    """The k interior integer candidates ``lo + span*j // (k+1)``.

    Same schedule as the host engine's integral branch, factored to avoid
    the ``span * j`` overflow: ``span*j // (k+1)`` is computed as
    ``(span // (k+1)) * j + ((span % (k+1)) * j) // (k+1)`` (exact
    identity), so no intermediate ever exceeds ``span``.
    """
    span = hi - lo
    return lo + (span // (k + 1)) * j + ((span % (k + 1)) * j) // (k + 1)


def wide_bisect_exact_device(feasible, lo, hi, *, k: int = 15):
    """Minimal feasible integer in [lo, hi] for B independent lanes.

    ``feasible(cand)`` maps a (B, k) integer candidate matrix to a (B, k)
    bool mask (monotone: once True, always True); every ``hi`` must be
    feasible.  Each round probes the host schedule's interior candidates
    and shrinks every [lo, hi] to the bracketing verdicts, until every
    lane has closed.  A closed lane (lo == hi, hi feasible) is left as it
    is by a round, so running the rounds over all lanes gives what the
    reference's vmapped ``while_loop`` (which freezes closed lanes) gives.
    """
    j = torch.arange(1, k + 1, dtype=lo.dtype, device=lo.device)
    while bool((lo < hi).any()):
        cand = _interior_candidates(lo[:, None], hi[:, None], j[None, :], k)
        feas = feasible(cand)
        hi_new = torch.where(feas, cand, hi[:, None]).amin(dim=1)
        lo_new = torch.where(feas, lo[:, None], cand + 1).amax(dim=1)
        lo, hi = torch.maximum(lo, lo_new), torch.minimum(hi, hi_new)
    return hi


# The reference's lockstep form over S rows (one probe round serves every
# row, which is what lets the per-stripe column solves share one probe
# kernel launch per round) is the same function here: every bisection of
# the port is batched.
_wide_bisect_exact_batch = wide_bisect_exact_device


# ---------------------------------------------------------------------------
# exact greedy realization (host ``oned.probe`` semantics, bit-for-bit)


def _greedy_cuts_exact(p: torch.Tensor, m: int,
                       L: torch.Tensor) -> torch.Tensor:
    """Greedy cuts (B, m+1) at a *feasible* L (B,), mirroring ``oned.probe``.

    Intervals extend maximally; once the remainder fits in one interval
    the chain collapses — cuts stay at the current position and the final
    cut takes the tail — the host probe's early-return pattern.
    """
    n = p.shape[-1] - 1
    Lc = L[:, None]
    pos = torch.zeros((p.shape[0], 1), dtype=torch.int64, device=p.device)
    cuts = [pos]
    for _ in range(m):
        rem_fits = p[:, n:] - p.gather(-1, pos) <= Lc
        pos = torch.where(rem_fits, pos, _advance(p, pos, Lc))
        cuts.append(pos)
    cuts = torch.cat(cuts, dim=1)
    cuts[:, m] = n
    return cuts.to(torch.int32)


def _cut_loads(p: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    c = cuts.long()
    return p.gather(-1, c[..., 1:]) - p.gather(-1, c[..., :-1])


def _exact_1d_bounds_int(p: torch.Tensor, m: int):
    """Integer [lo, hi] bracketing each row's 1D optimum: lo any lower
    bound, hi a feasible integer (floor of the DirectCut bound, +1 for the
    integer-division slack).  p (B, N+1) -> (B,), (B,)."""
    n = p.shape[-1] - 1
    total = p[:, n]
    maxel = torch.diff(p, dim=-1).amax(dim=-1)
    lo = torch.maximum((total + m - 1) // m, maxel)
    hi = total // m + maxel + 1
    return lo, torch.maximum(hi, lo)


# ---------------------------------------------------------------------------
# exact P x Q jagged (JAG-PQ-OPT)


def _bs_steps(n1: int) -> int:
    """Static binary-search step count resolving an index in [0, n1+1)."""
    return max(1, math.ceil(math.log2(n1 + 2)))


def _stripe_row(gamma: torch.Tensor, b: torch.Tensor,
                e: torch.Tensor) -> torch.Tensor:
    """Column prefix arrays of stripes [b, e): gamma (T, n1+1, n2+1), b, e
    (T, K) -> (T, K, n2+1), each row non-decreasing."""
    t = torch.arange(gamma.shape[0], device=gamma.device)[:, None]
    return gamma[t, e] - gamma[t, b]


def _stripe_fits(gamma: torch.Tensor, b, e, L, Q: int) -> torch.Tensor:
    """Does stripe [b, e) pack into <= Q column intervals of load <= L?

    Greedy maximal extension over the stripe's column prefix (exact for
    the monotone objective); b, e, L are (T, K) -> (T, K) bool.
    """
    q = _stripe_row(gamma, b, e)
    n2 = q.shape[-1] - 1
    Lc = L[..., None]
    pos = torch.zeros(b.shape + (1,), dtype=torch.int64, device=q.device)
    for _ in range(Q):
        target = q.gather(-1, pos) + Lc
        nxt = torch.searchsorted(q, target, right=True) - 1
        pos = torch.maximum(nxt, pos).clamp_max(n2)
    return pos[..., 0] == n2


def _largest_stripe_end(gamma: torch.Tensor, b, L, Q: int) -> torch.Tensor:
    """Largest e in [b, n1] whose stripe [b, e) fits (binary search).

    Fitting is monotone non-increasing in e (pointwise load domination).
    The empty stripe always fits, so the invariant end is ``b``; the step
    count is static (worst case over the whole row range).
    """
    n1 = gamma.shape[1] - 1
    glo = b
    ghi = torch.full_like(b, n1 + 1)
    for _ in range(_bs_steps(n1)):
        mid = (glo + ghi) // 2
        ok = _stripe_fits(gamma, b, mid, L, Q)
        glo, ghi = torch.where(ok, mid, glo), torch.where(ok, ghi, mid)
    return glo


def _row_scan(gamma: torch.Tensor, L: torch.Tensor, P: int, Q: int, *,
              realize: bool = False) -> torch.Tensor:
    """P greedy stripe steps at bottlenecks L (T, K).

    ``realize=False``: feasibility — final position == n1, (T, K) bool.
    ``realize=True``: the host ``_RowProbe.cuts`` realization — once the
    remainder fits the chain collapses (cuts stay at b, final cut n1) —
    as (T, K, P+1) int32 cuts.
    """
    n1 = gamma.shape[1] - 1
    b = torch.zeros(L.shape, dtype=torch.int64, device=gamma.device)
    cuts = [b]
    for _ in range(P):
        e = _largest_stripe_end(gamma, b, L, Q)
        if realize:
            rem = _stripe_fits(gamma, b, torch.full_like(b, n1), L, Q)
            e = torch.where(rem, b, e)
        b = torch.maximum(e, b)
        cuts.append(b)
    if not realize:
        return b == n1
    cuts = torch.stack(cuts, dim=-1)
    cuts[..., P] = n1
    return cuts.to(torch.int32)


def _collapse_cuts(n2: int, m: int, device=None) -> torch.Tensor:
    """The host probe's zero-load pattern: [0, ..., 0, n2]."""
    cuts = torch.zeros(m + 1, dtype=torch.int32, device=device)
    cuts[m] = n2
    return cuts


def jag_pq_opt_device_impl(gamma: torch.Tensor, *, P: int, Q: int,
                           speeds=None, k: int = 15):
    """JAG-PQ-OPT on device for an int32 Gamma or (T, n1+1, n2+1) stack.

    'hor' orientation (transpose the Gamma for 'ver').  Returns
    ``(row_cuts (T, P+1), counts (T, P) == Q, col_cuts (T, P, Q+1),
    Lmax (T,))`` (no T axis for a 2D Gamma), bit-identical to the
    reference's integer branch: the row probe is the same greedy maximal
    stripe extension, and the per-stripe column solves converge to each
    stripe's own minimal feasible integer before realizing with the host
    probe's collapse semantics.  The column feasibility probes of all
    frames and stripes go through one probe-kernel launch per round (the
    reference's ``use_pallas_probe=True``).

    Every frame's total load must be below 2**30 (greedy targets
    ``p + L`` stay inside int32).  ``speeds=`` and float Gammas are not
    ported yet and raise ``NotImplementedError``.
    """
    if speeds is not None:
        raise NotImplementedError("jag_pq_opt_device_impl: the speeds= "
                                  "branch is not ported yet")
    if gamma.dtype != torch.int32:
        raise NotImplementedError(
            f"jag_pq_opt_device_impl is ported for int32 Gamma (the exact "
            f"integer branch), got {gamma.dtype}")
    g, squeeze = _as_batch(gamma)
    T, n1, n2 = g.shape[0], g.shape[1] - 1, g.shape[2] - 1
    m = P * Q
    total = g[:, n1, n2]
    if bool((total >= _INT_LIMIT).any()):
        raise ValueError(f"exact planning needs every frame's total load "
                         f"below 2**30, got {int(total.max())}")
    maxrow = torch.diff(g[:, :, n2], dim=-1).amax(dim=-1)
    # the per-stripe column greedy's "element" is a column sum *within the
    # stripe*, bounded by the full-column load — not by the max cell
    maxcol = torch.diff(g[:, n1, :], dim=-1).amax(dim=-1)
    lo = (total + m - 1) // m
    hi = torch.maximum(total // m + maxrow // Q + maxcol + 2, lo)

    L = wide_bisect_exact_device(lambda cand: _row_scan(g, cand, P, Q),
                                 lo, hi, k=k)
    row_cuts = _row_scan(g, L[:, None], P, Q, realize=True)[:, 0]
    t = torch.arange(T, device=g.device)[:, None]
    rc = row_cuts.long()
    sm = (g[t, rc[:, 1:]] - g[t, rc[:, :-1]]).reshape(T * P, n2 + 1)

    # per-stripe exact column solves, lockstep across frames and stripes:
    # one probe-kernel launch per round serves every open stripe
    los, his = _exact_1d_bounds_int(sm, Q)
    Ls = _wide_bisect_exact_batch(
        lambda cand: probe_ops.probe_counts(sm, cand.to(sm.dtype), Q) <= Q,
        los, his, k=k)
    col_cuts = _greedy_cuts_exact(sm, Q, Ls)
    bots = _cut_loads(sm, col_cuts).amax(dim=-1).reshape(T, P)
    counts = torch.full((T, P), Q, dtype=torch.int32, device=g.device)
    return _unbatch((row_cuts, counts, col_cuts.reshape(T, P, Q + 1),
                     bots.amax(dim=1)), squeeze)
