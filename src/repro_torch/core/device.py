"""On-device partitioners: the port of ``repro.core.device``.

The reference writes each solver for one Gamma and batches it with
``vmap``; its loops are ``lax.scan`` / ``lax.while_loop``.  Here every
function carries its batch axes explicitly — frames, stripes and
candidate bottlenecks — and the loops are Python loops over those batched
tensors, never over frames:

- fixed-length scans (the ``m``-step probes, the ``rounds`` of
  :func:`wide_bisect_device`) run their fixed count with no host sync;
- the bisections that run until they close (:func:`wide_bisect_exact_device`,
  :func:`wide_bisect_float_device`) read one flag per round (``.item()``)
  over all lanes and stop when every lane has converged; a lane that has
  closed keeps its interval, as under the reference's vmapped
  ``while_loop``.

Solvers:

- :func:`jag_m_heur_device_impl`, the paper's JAG-M-HEUR (the planner's
  default) on float32 accumulators, bit-identical to the reference where
  every frame total is below 2**24, or on float64 accumulators,
  bit-identical to the reference under x64 (exact for integer loads
  below 2**53);
- :func:`nicol_optimal_device_impl`, the exact 1D solver;
- :func:`jag_pq_opt_device_impl`, the exact JAG-PQ-OPT;
- :func:`jag_m_opt_device_impl`, the exact JAG-M-OPT (small instances).

The exact solvers take int32 (total load below 2**30: the greedy targets
``p + L`` stay inside int32; larger totals raise ``ValueError``) or
float32 (bisected to the reference's float tolerance), and the 1D and
P x Q ones a ``speeds=`` vector (the relative-load objective, always
float32).  On int32 they are bit-identical to the reference.  Their
feasibility probes of whole prefix rows (the 1D solve and the per-stripe
column solves) run through the probe kernel (``kernels.probe``); the
greedy steps of the stripe walks are ``torch.searchsorted`` on the
current device.

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


# Veltkamp's constant for float64: 2**27 + 1 splits a double into two
# halves of 26 significant bits whose products are exact
_SPLIT_F64 = 134217729.0


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """``(s, e)`` with ``s = fl(a + b)`` and ``s + e == a + b`` exactly
    (Knuth's branch-free two-sum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """``(p, e)`` with ``p = fl(a * b)`` and ``p + e == a * b`` exactly
    (Dekker's product over Veltkamp splits; no overflow or underflow)."""
    def split(x):
        t = x * _SPLIT_F64
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    p = a * b
    return p, al * bl - (((p - ah * bh) - al * bh) - ah * bl)


def _fma_f64(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float64 tensors, rounded once.

    XLA fuses the float64 candidate schedule as it fuses the float32 one
    (:func:`_fma_f32`), and torch has no fused multiply-add, so this is
    Boldo and Melquiond's emulation from separate elementwise operations
    (none of which a compiler can contract into an FMA of its own): the
    exact product ``uh + ul``, the exact sum ``th + tl = c + uh``, the sum
    ``tl + ul`` rounded to odd (its exact error decides the last bit, as
    in :func:`_fma_f32`), and one final rounded add.  Correct for finite
    values whose products neither overflow nor underflow.
    """
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(v, math.inf), err)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


#: the candidate schedule's fused multiply-add, by accumulator dtype
_FMA = {torch.float32: _fma_f32, torch.float64: _fma_f64}


def _fractions(k: int, like: torch.Tensor) -> torch.Tensor:
    """The candidate fractions ``i / (k+1)``, i = 1..k, as the reference
    computes them: XLA turns the division by the constant ``k+1`` into a
    multiplication by its reciprocal, so each is ``i * fl(1 / (k+1))``,
    which is one ulp off ``fl(i / (k+1))`` for some i and k (float64 k=8,
    i=7; float32 k=5)."""
    recip = torch.ones((), dtype=like.dtype, device=like.device) / (k + 1)
    return torch.arange(1, k + 1, dtype=like.dtype, device=like.device) * recip


def _check_float_dtype(name: str, dtype: torch.dtype) -> None:
    if dtype not in _FMA:
        raise NotImplementedError(
            f"{name} is ported for float32 and float64 accumulators, got "
            f"{dtype}")


def wide_bisect_device(feasible, lo: torch.Tensor, hi: torch.Tensor, *,
                       k: int = 8, rounds: int = 8):
    """K candidates per round over B independent float32 or float64
    intervals.

    ``feasible(Ls)`` maps an ascending (B, k) candidate matrix to a (B, k)
    bool mask (monotone).  Returns the final (lo, hi), each (B,); hi
    converges to the optimum from above, within (hi0-lo0)/(k+1)^rounds.
    Runs exactly ``rounds`` rounds with no host sync.
    """
    _check_float_dtype("wide_bisect_device", lo.dtype)
    fma = _FMA[lo.dtype]
    fr = _fractions(k, lo)
    for _ in range(rounds):
        Ls = fma((hi - lo)[:, None], fr[None, :], lo[:, None])
        feas = feasible(Ls)
        # new hi: smallest feasible candidate (or old hi)
        hi_new = torch.where(feas, Ls, hi[:, None]).amin(dim=1)
        # new lo: largest infeasible candidate (or old lo)
        lo_new = torch.where(~feas, Ls, lo[:, None]).amax(dim=1)
        lo, hi = torch.minimum(lo_new, hi_new), hi_new
    return lo, hi


def optimal_1d_device(p: torch.Tensor, m: int, *, k: int = 8,
                      rounds: int = 8):
    """Optimal 1D partitions of B float32 or float64 prefix rows (B, N+1)
    by wide bisection.  Returns (cuts (B, m+1), bottleneck (B,))."""
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
    arrays), float32 or float64.  Defaults to the Gamma's own dtype when
    that is floating, else float32, as the reference's.  f32 ulps exceed
    1 above 2**24, so results there may differ from the reference's in the
    last places of Gamma; float64 keeps integer loads exact below 2**53.
    Returns (row_cuts (T, P+1), counts (T, P), col_cuts (T, P, m_max+1),
    Lmax (T,)) with m_max = m - P + 1 (a stripe can never get more than
    that, since every other stripe keeps at least one processor); a 2D
    Gamma gives the same without the T axis.
    """
    gd = gamma_dtype
    if gd is None:
        gd = gamma.dtype if gamma.dtype.is_floating_point else torch.float32
    _check_float_dtype("jag_m_heur_device_impl", gd)
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


def _raise_to_feasible(feasible, hi: torch.Tensor, bad: torch.Tensor, *,
                       max_steps: int = 64) -> torch.Tensor:
    """``hi`` raised ulp by ulp on the lanes ``bad`` until it is
    feasible there; the other lanes are left as they are."""
    for _ in range(max_steps):
        hi = torch.where(bad, torch.nextafter(hi, hi.new_tensor(math.inf)),
                         hi)
        bad = bad & ~feasible(hi[:, None])[:, 0]
        if not bool(bad.any()):
            break
    return hi


def _bisect_speeds(feasible, realize, reached, lo, hi, *, k: int):
    """The float bisection of a ``speeds=`` branch and its realization.

    ``realize(L)`` gives the cuts at the bottlenecks L (B,), and
    ``reached(cuts)`` whether they cover the whole row, that is whether
    L was feasible.  The speeds branches start from ``hi = (total / s) *
    (1 + 1e-9) + 1e-12``, the bound at which speed ``s`` alone carries
    the whole load; in float32 the ``1 + 1e-9`` rounds to 1, so ``hi *
    s`` may fall one ulp short of the total and ``hi`` be infeasible
    (P8), where the reference returns cuts that fall short of n.
    Feasibility is monotone, so such a lane bisects to its ``hi`` and its
    cuts fall short: only those lanes have ``hi`` raised ulp by ulp until
    it is feasible and are bisected again from their ``lo``, the others
    held closed at their result.  A lane whose ``hi`` is feasible (every
    other case) is bit-identical to the reference's and costs nothing
    more; a NaN lane (no live speed) is left as it is.
    """
    L = wide_bisect_float_device(feasible, lo, hi, k=k)
    cuts = realize(L)
    bad = ~reached(cuts) & ~L.isnan()
    if bool(bad.any()):
        hi = _raise_to_feasible(feasible, L, bad)
        L = wide_bisect_float_device(feasible, torch.where(bad, lo, L), hi,
                                     k=k)
        cuts = realize(L)
    return L, cuts


def wide_bisect_float_device(feasible, lo, hi, *, k: int = 15,
                             rel_tol: float = 1e-9, abs_tol: float = 1e-12,
                             max_rounds: int = 128):
    """Float twin over B independent float32 lanes: converge each ``hi``
    to within the host engine's tolerance.

    Candidates ``lo + (hi - lo) * j/(k+1)`` (rounded once, as the
    reference's compiled loop computes them); a lane is open while
    ``hi - lo > max(rel * |hi|, abs_tol)`` and it has run fewer than
    ``max_rounds`` rounds, with ``rel`` floored at 4 float32 ulps so
    every lane terminates.  A closed lane keeps its interval (and its
    round count) while the others go on, as under the reference's vmapped
    ``while_loop``; a NaN interval is closed from the start.
    """
    if lo.dtype != torch.float32 or hi.dtype != torch.float32:
        raise TypeError(f"wide_bisect_float_device takes float32 bounds, "
                        f"got {lo.dtype} and {hi.dtype}")
    rel = max(rel_tol, 4 * float(torch.finfo(torch.float32).eps))
    fr = _fractions(k, lo)
    rounds = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)

    def is_open(lo, hi, rounds):
        return ((hi - lo > torch.clamp_min(rel * hi.abs(), abs_tol))
                & (rounds < max_rounds))

    live = is_open(lo, hi, rounds)
    while bool(live.any()):
        cand = _fma_f32((hi - lo)[:, None], fr[None, :], lo[:, None])
        feas = feasible(cand)
        hi_new = torch.where(feas, cand, hi[:, None]).amin(dim=1)
        lo_new = torch.where(feas, lo[:, None], cand).amax(dim=1)
        lo = torch.where(live, torch.maximum(lo, lo_new), lo)
        hi = torch.where(live, torch.minimum(hi, hi_new), hi)
        rounds = rounds + live.to(torch.int32)
        live = is_open(lo, hi, rounds)
    return hi


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


def _greedy_cuts_speeds(p: torch.Tensor, L: torch.Tensor,
                        speeds: torch.Tensor) -> torch.Tensor:
    """Capacity-aware greedy cuts: position i packs at most ``L *
    speeds[i]``.  p (B, N+1), L (B, K), speeds (B, m) -> (B, K, m+1).

    Mirrors the hetero branch of the host probe: dead (speed 0) positions
    keep the current cut (an empty interval), no remainder collapse.  At
    an infeasible L the final cut falls short of n.  The reference adds a
    float32 ``L * speed`` to an int32 row, so the row is promoted and the
    search compares in float32; the port casts the row the same way.
    """
    pf = p.to(L.dtype)
    pos = torch.zeros(L.shape, dtype=torch.int64, device=p.device)
    cuts = [pos]
    for i in range(speeds.shape[-1]):
        sp = speeds[:, i:i + 1]
        pos = torch.where(sp > 0, _advance(pf, pos, L * sp), pos)
        cuts.append(pos)
    return torch.stack(cuts, dim=-1)


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


def _check_exact_input(x: torch.Tensor, total: torch.Tensor,
                       name: str) -> bool:
    """The exact solvers take int32 (totals below 2**30) or float32;
    returns whether ``x`` is integral."""
    if x.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"{name} takes an int32 or float32 input, got "
                        f"{x.dtype}")
    integral = x.dtype == torch.int32
    if integral and bool((total >= _INT_LIMIT).any()):
        raise ValueError(f"{name}: exact planning on int32 needs every "
                         f"total load below 2**30, got {int(total.max())}")
    return integral


def _speeds_batch(speeds, T: int, m: int, device) -> torch.Tensor:
    """A speed vector (m,) or per-frame speeds (T, m) as (T, m) float32."""
    sp = torch.as_tensor(speeds, device=device).to(torch.float32)
    if sp.shape[-1] != m:
        raise ValueError(f"speeds must have m={m} entries, got "
                         f"{tuple(sp.shape)}")
    return sp.expand(T, m) if sp.ndim == 1 else sp


def _probe_feasible(p: torch.Tensor, m: int):
    """Feasibility of (B, K) candidates on prefix rows p (B, N+1) with at
    most m intervals, through the probe kernel."""
    return lambda cand: probe_ops.probe_counts(p, cand.to(p.dtype), m) <= m


# ---------------------------------------------------------------------------
# exact 1D


def nicol_optimal_device_impl(p: torch.Tensor, m: int,
                              speeds: torch.Tensor | None = None, *,
                              k: int = 15):
    """Exact 1D partitions of prefix rows p (N+1,) or (B, N+1).

    Returns ``(cuts (B, m+1) int32, bottleneck (B,))`` (no B axis for a
    single row).  int32 rows take the exact integer bisection (bottleneck
    and cuts bit-identical to the reference and to the host
    ``oned.nicol_optimal``); float32 rows converge to the host float
    tolerance.  Both probe feasibility through the probe kernel.
    ``speeds`` ((m,) or (B, m), already normalized by
    ``search.normalize_speeds``) switches to the relative-load objective
    in float32: the bottleneck is the largest ``load / speed`` and dead
    (speed 0) positions get empty intervals.
    """
    squeeze = p.ndim == 1
    p = p[None] if squeeze else p
    n = p.shape[-1] - 1
    integral = _check_exact_input(p, p[:, n], "nicol_optimal_device_impl")
    if speeds is not None:
        sp = _speeds_batch(speeds, p.shape[0], m, p.device)
        pf = p.to(torch.float32)
        total = pf[:, n] - pf[:, 0]
        maxel = torch.diff(pf, dim=-1).amax(dim=-1)
        smax = sp.amax(dim=-1)
        # the speed sum in float64, then rounded once: the same value on
        # the CPU and on the card, whatever order either sums in
        ssum = sp.double().sum(dim=-1).to(torch.float32)
        lo = torch.maximum(total / ssum, maxel / smax)
        hi = (total / smax) * (1 + 1e-9) + 1e-12

        def feasible(cand):
            return _greedy_cuts_speeds(p, cand, sp)[..., -1] == n

        L, cuts = _bisect_speeds(
            feasible, lambda L: _greedy_cuts_speeds(p, L[:, None], sp)[:, 0],
            lambda cuts: cuts[:, -1] == n, lo, hi, k=k)
        loads = _cut_loads(p, cuts).to(torch.float32)
        rel = torch.where(loads > 0, loads / sp, 0.0)
        out = (cuts.to(torch.int32), rel.amax(dim=-1))
        return tuple(x[0] for x in out) if squeeze else out

    if integral:
        lo, hi = _exact_1d_bounds_int(p, m)
        L = wide_bisect_exact_device(_probe_feasible(p, m), lo, hi, k=k)
    else:
        total = p[:, n]
        maxel = torch.diff(p, dim=-1).amax(dim=-1)
        lo = torch.maximum(total / m, maxel)
        hi = total / m + maxel
        L = wide_bisect_float_device(_probe_feasible(p, m), lo, hi, k=k)
    cuts = _greedy_cuts_exact(p, m, L)
    out = (cuts, _cut_loads(p, cuts).amax(dim=-1))
    return tuple(x[0] for x in out) if squeeze else out


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


def _stripe_fits(gamma: torch.Tensor, b, e, L, Q: int,
                 sp_slice: torch.Tensor | None = None) -> torch.Tensor:
    """Does stripe [b, e) pack into <= Q column intervals of load <= L?

    Greedy maximal extension over the stripe's column prefix (exact for
    the monotone objective); b, e, L are (T, K) -> (T, K) bool.  With
    ``sp_slice`` ((T, Q) speeds) position q packs at most ``L *
    sp_slice[q]`` and dead positions are skipped (the row promoted to
    float32, as in :func:`_greedy_cuts_speeds`).
    """
    q = _stripe_row(gamma, b, e)
    n2 = q.shape[-1] - 1
    Lc = L[..., None]
    pos = torch.zeros(b.shape + (1,), dtype=torch.int64, device=q.device)
    if sp_slice is None:
        for _ in range(Q):
            pos = _advance(q, pos, Lc)
        return pos[..., 0] == n2
    q = q.to(L.dtype)
    for i in range(Q):
        sp = sp_slice[:, None, i:i + 1]
        pos = torch.where(sp > 0, _advance(q, pos, Lc * sp), pos)
    return pos[..., 0] == n2


def _largest_stripe_end(gamma: torch.Tensor, b, L, Q: int,
                        sp_slice: torch.Tensor | None = None) -> torch.Tensor:
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
        ok = _stripe_fits(gamma, b, mid, L, Q, sp_slice)
        glo, ghi = torch.where(ok, mid, glo), torch.where(ok, ghi, mid)
    return glo


def _row_scan(gamma: torch.Tensor, L: torch.Tensor, P: int, Q: int,
              sp2: torch.Tensor | None = None, *,
              realize: bool = False) -> torch.Tensor:
    """P greedy stripe steps at bottlenecks L (T, K).

    ``realize=False``: feasibility — final position == n1, (T, K) bool.
    ``realize=True``: the host ``_RowProbe.cuts`` realization — once the
    remainder fits the chain collapses (cuts stay at b, final cut n1) —
    as (T, K, P+1) int32 cuts.  ``sp2`` is the (T, P, Q) per-stripe speed
    schedule of the capacity-aware form, which (like the host hetero
    realizer) has no collapse shortcut.
    """
    n1 = gamma.shape[1] - 1
    b = torch.zeros(L.shape, dtype=torch.int64, device=gamma.device)
    cuts = [b]
    for s in range(P):
        if sp2 is None:
            e = _largest_stripe_end(gamma, b, L, Q)
            if realize:
                rem = _stripe_fits(gamma, b, torch.full_like(b, n1), L, Q)
                e = torch.where(rem, b, e)
        else:
            e = _largest_stripe_end(gamma, b, L, Q, sp2[:, s])
        b = torch.maximum(e, b)
        cuts.append(b)
    if not realize:
        return b == n1
    cuts = torch.stack(cuts, dim=-1)
    if sp2 is None:
        cuts[..., P] = n1
    return cuts.to(torch.int32)


def _collapse_cuts(n2: int, m: int, device=None) -> torch.Tensor:
    """The host probe's zero-load pattern: [0, ..., 0, n2]."""
    cuts = torch.zeros(m + 1, dtype=torch.int32, device=device)
    cuts[m] = n2
    return cuts


def jag_pq_opt_device_impl(gamma: torch.Tensor, *, P: int, Q: int,
                           speeds=None, k: int = 15):
    """JAG-PQ-OPT on device for a Gamma or a (T, n1+1, n2+1) stack.

    'hor' orientation (transpose the Gamma for 'ver'; the registry
    adapter runs both and keeps the better, like the host
    ``orient='best'``).  Returns ``(row_cuts (T, P+1), counts (T, P) ==
    Q, col_cuts (T, P, Q+1), Lmax (T,))`` (no T axis for a 2D Gamma).

    An int32 Gamma (every frame's total below 2**30) takes the exact
    integer bisection, bit-identical to the reference: the row probe is
    the same greedy maximal stripe extension, and the per-stripe column
    solves converge to each stripe's own minimal feasible integer before
    realizing with the host probe's collapse semantics.  A float32 Gamma
    bisects both levels to the host float tolerance.  The column
    feasibility probes of all frames and stripes go through one
    probe-kernel launch per round (the reference's ``use_pallas_probe=
    True``).  ``speeds`` ((P*Q,) or (T, P*Q), pre-normalized) switches
    everything to relative load in float32: each stripe's columns are
    then an exact 1D speeds solve (:func:`nicol_optimal_device_impl`).
    """
    g, squeeze = _as_batch(gamma)
    T, n1, n2 = g.shape[0], g.shape[1] - 1, g.shape[2] - 1
    m = P * Q
    total = g[:, n1, n2]
    integral = _check_exact_input(g, total, "jag_pq_opt_device_impl")
    t = torch.arange(T, device=g.device)[:, None]

    def stripes(row_cuts):
        rc = row_cuts.long()
        return (g[t, rc[:, 1:]] - g[t, rc[:, :-1]]).reshape(T * P, n2 + 1)

    counts = torch.full((T, P), Q, dtype=torch.int32, device=g.device)
    if speeds is not None:
        sp = _speeds_batch(speeds, T, m, g.device)
        sp2 = sp.reshape(T, P, Q)
        smin_pos = torch.where(sp > 0, sp, math.inf).amin(dim=-1)
        totf = total.to(torch.float32)
        lo = totf / sp.double().sum(dim=-1).to(torch.float32)
        hi = torch.maximum((totf / smin_pos) * (1 + 1e-9) + 1e-12, lo)

        def feasible(cand):
            return _row_scan(g, cand, P, Q, sp2)

        L, row_cuts = _bisect_speeds(
            feasible,
            lambda L: _row_scan(g, L[:, None], P, Q, sp2, realize=True)[:, 0],
            lambda cuts: cuts[:, -1] == n1, lo, hi, k=k)
        sm = stripes(row_cuts)
        cuts, bots = nicol_optimal_device_impl(sm, Q, sp2.reshape(T * P, Q),
                                               k=k)
        zero = (sm[:, n2] - sm[:, 0] <= 0)
        cuts = torch.where(zero[:, None], _collapse_cuts(n2, Q, g.device),
                           cuts)
        bots = torch.where(zero, 0.0, bots).reshape(T, P)
        return _unbatch((row_cuts, counts, cuts.reshape(T, P, Q + 1),
                         bots.amax(dim=1)), squeeze)

    maxrow = torch.diff(g[:, :, n2], dim=-1).amax(dim=-1)
    # the per-stripe column greedy's "element" is a column sum *within the
    # stripe*, bounded by the full-column load — not by the max cell
    maxcol = torch.diff(g[:, n1, :], dim=-1).amax(dim=-1)
    if integral:
        lo = (total + m - 1) // m
        hi = torch.maximum(total // m + maxrow // Q + maxcol + 2, lo)
        L = wide_bisect_exact_device(lambda cand: _row_scan(g, cand, P, Q),
                                     lo, hi, k=k)
    else:
        lo = total / m
        hi = torch.maximum((total / m + maxrow / Q + maxcol) * (1 + 1e-9)
                           + 1e-12, lo)
        L = wide_bisect_float_device(lambda cand: _row_scan(g, cand, P, Q),
                                     lo, hi, k=k)
    row_cuts = _row_scan(g, L[:, None], P, Q, realize=True)[:, 0]
    sm = stripes(row_cuts)

    # per-stripe column solves, lockstep across frames and stripes: one
    # probe-kernel launch per round serves every open stripe
    if integral:
        los, his = _exact_1d_bounds_int(sm, Q)
        Ls = _wide_bisect_exact_batch(_probe_feasible(sm, Q), los, his, k=k)
    else:
        el = torch.diff(sm, dim=-1).amax(dim=-1)
        los = torch.maximum(sm[:, n2] / Q, el)
        his = sm[:, n2] / Q + el
        Ls = wide_bisect_float_device(_probe_feasible(sm, Q), los, his, k=k)
    col_cuts = _greedy_cuts_exact(sm, Q, Ls)
    bots = _cut_loads(sm, col_cuts).amax(dim=-1).reshape(T, P)
    return _unbatch((row_cuts, counts, col_cuts.reshape(T, P, Q + 1),
                     bots.amax(dim=1)), squeeze)


# ---------------------------------------------------------------------------
# exact m-way jagged (JAG-M-OPT; small instances)


def _jump(gamma: torch.Tensor, b, L, x, steps: int) -> torch.Tensor:
    """Largest e with stripe [b, e) packing into <= x intervals at L.

    b, L, x (T, J) -> (T, J).  The binary search of the reference over the
    masked greedy (``_stripe_count_leq``: steps past x leave the position
    as it is); ``steps`` >= max(x) greedy steps are run, the rest being
    no-ops for every lane.
    """
    n1 = gamma.shape[1] - 1
    n2 = gamma.shape[2] - 1
    Lc = L[..., None]
    xc = x[..., None]
    glo = b
    ghi = torch.full_like(b, n1 + 1)
    for _ in range(_bs_steps(n1)):
        mid = (glo + ghi) // 2
        q = _stripe_row(gamma, b, mid)
        pos = torch.zeros(b.shape + (1,), dtype=torch.int64, device=q.device)
        for i in range(steps):
            pos = torch.where(i < xc, _advance(q, pos, Lc), pos)
        ok = pos[..., 0] == n2
        glo, ghi = torch.where(ok, mid, glo), torch.where(ok, ghi, mid)
    return glo


def _jag_m_reach(gamma: torch.Tensor, L: torch.Tensor, m: int):
    """Reach DP at bottlenecks L (T, K): r[q] = furthest row coverable by
    q processors, ``max over x in [1, q] of jump_x(r[q - x])``.

    Returns ``(r, xs)``, each (T, K, m+1) int64: xs[q] is the smallest x
    reaching r[q] (1 where nothing is reached), the reference's choice
    for the realization backtrack.  Feasible iff r[m] == n1.  Every
    r[q - x] with x <= q is known before step q, so each step runs its q
    choices of x as lanes of one batched jump.
    """
    T, K = L.shape
    r = torch.zeros((T, K, m + 1), dtype=torch.int64, device=L.device)
    xs = torch.zeros_like(r)
    for q in range(1, m + 1):
        x = torch.arange(1, q + 1, device=L.device)          # (q,)
        b = r[:, :, q - x]                                    # (T, K, q)
        e = _jump(gamma, b.reshape(T, K * q),
                  L[:, :, None].expand(T, K, q).reshape(T, K * q),
                  x.expand(T, K, q).reshape(T, K * q), q).reshape(T, K, q)
        best = e.amax(dim=-1)
        got = best > 0
        r[:, :, q] = torch.where(got, best, 0)
        xs[:, :, q] = torch.where(got, e.argmax(dim=-1) + 1, 1)
    return r, xs


def jag_m_opt_device_impl(gamma: torch.Tensor, *, m: int, k: int = 7):
    """JAG-M-OPT on device for a Gamma or a (T, n1+1, n2+1) stack.

    Exact m-way jagged: bisect the bottleneck with the reach DP as the
    feasibility probe, then backtrack the recorded stripe choices and
    realize per-stripe column cuts greedily at L*.  int32 Gammas (totals
    below 2**30) give outputs bit-identical to the reference (bottleneck
    equal to the host ``jagged.jag_m_opt(orient='hor')``'s); float32 ones
    bisect to the host float tolerance.  Like the host DP this is for
    small instances: each candidate round runs m * log2(n1) * m greedy
    steps one after another.

    Returns ``(row_cuts (T, m+1), counts (T, m), col_cuts (T, m, m+1),
    n_stripes (T,), Lmax (T,))`` — stripe arrays padded to m with empty
    stripes; no T axis for a 2D Gamma.
    """
    g, squeeze = _as_batch(gamma)
    T, n1, n2 = g.shape[0], g.shape[1] - 1, g.shape[2] - 1
    total = g[:, n1, n2]
    integral = _check_exact_input(g, total, "jag_m_opt_device_impl")
    cells = g[:, 1:, 1:] - g[:, :-1, 1:] - g[:, 1:, :-1] + g[:, :-1, :-1]
    maxel = cells.reshape(T, -1).amax(dim=-1)
    colmax = torch.diff(g[:, n1, :], dim=-1).amax(dim=-1)

    def feasible(cand):
        return _jag_m_reach(g, cand, m)[0][..., m] == n1

    if integral:
        lo = torch.maximum((total + m - 1) // m, maxel)
        hi = torch.maximum(total // m + colmax + 1, lo)
        L = wide_bisect_exact_device(feasible, lo, hi, k=k)
    else:
        lo = torch.maximum(total / m, maxel)
        hi = torch.maximum((total / m + colmax) * (1 + 1e-9) + 1e-12, lo)
        L = wide_bisect_float_device(feasible, lo, hi, k=k)
    r, xs = (a[:, 0] for a in _jag_m_reach(g, L[:, None], m))   # (T, m+1)

    # backtrack: from q = m walk the recorded x choices; emits stripes
    # last-first, padded with x = 0 once q hits 0
    q = torch.full((T, 1), m, dtype=torch.int64, device=g.device)
    bs, es, xr = [], [], []
    for _ in range(m):
        x = torch.where(q > 0, xs.gather(1, q), 0)
        e = r.gather(1, q)
        b = r.gather(1, q - x)
        bs.append(b)
        es.append(torch.where(x > 0, e, b))
        xr.append(x)
        q = q - x
    bs, es, xr = (torch.cat(v[::-1], dim=1) for v in (bs, es, xr))
    live = xr > 0
    n_stripes = live.sum(dim=1).to(torch.int32)
    # compact live stripes to the front (stable order); pad slots are the
    # empty stripe [n1, n1), so they carry no load
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    slot = torch.arange(m, device=g.device)[None, :]
    keep = slot < n_stripes[:, None]
    starts = torch.where(keep, bs.gather(1, order), n1)
    ends = torch.where(keep, es.gather(1, order), n1)
    counts = torch.where(keep, xr.gather(1, order), 0)
    row_cuts = torch.cat([torch.zeros_like(ends[:, :1]), ends],
                         dim=1).to(torch.int32)

    p_s = _stripe_row(g, starts, ends).reshape(T * m, n2 + 1)
    cnt = counts.reshape(T * m)
    Ls = L.repeat_interleave(m)[:, None]
    cuts = _probe_cuts_masked(p_s, m, cnt, Ls)[:, 0]
    dead = cnt == 0
    cuts = torch.where(dead[:, None], _collapse_cuts(n2, m, g.device).long(),
                       cuts)
    bots = _cut_loads(p_s, cuts).amax(dim=-1)
    bots = torch.where(dead, torch.zeros_like(bots), bots).reshape(T, m)
    return _unbatch((row_cuts, counts.to(torch.int32),
                     cuts.reshape(T, m, m + 1).to(torch.int32), n_stripes,
                     bots.amax(dim=1)), squeeze)
