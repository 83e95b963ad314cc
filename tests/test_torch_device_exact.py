"""Parity of the port's exact device solvers (``repro_torch.core.device``)
with the JAX package's, on the CPU: the exact 1D solver
(``nicol_optimal_device_impl``), the float and ``speeds=`` branches of
JAG-PQ-OPT and JAG-M-OPT.

The sweeps are those of ``tests/test_search_equivalence.py`` (the
reference against its host engine), run here port against reference on
the same NumPy inputs, each batch of instances through one jitted
reference call.  Tolerances:

- int32: none; cuts, counts and bottlenecks are bit-identical to the
  reference and to the host engine's (``oned.nicol_optimal``,
  ``jagged.jag_pq_opt``, ``jagged.jag_m_opt``);
- float32 and ``speeds=``: the achieved (relative) bottleneck within a
  relative 1e-5 (absolute 1e-6) of the reference's and of the host
  engine's, the tolerance of the reference's own sweeps.  The port also
  matches the reference bit for bit there on these inputs, since it
  rounds the float32 bisection candidates once, as XLA does
  (``test_wide_bisect_float_candidates_match_jax``); the bit-for-bit
  checks are the stronger ones, the tolerances are the contract.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.core import device as jax_dev
from repro.core import jagged, oned, prefix, search
from repro_torch.core import device as dev

_PAD_N = 48


def _padded_prefix(rng, float_dtype=False) -> np.ndarray:
    """A random prefix padded to _PAD_N elements with zero loads (the
    reference sweep's ``_padded_prefix``): runs of zeros, spikes and
    uniform stretches."""
    n = int(rng.integers(1, _PAD_N + 1))
    kind = rng.integers(0, 3)
    if kind == 0:
        v = rng.integers(0, 100, n)
    elif kind == 1:
        v = np.where(rng.random(n) < 0.3, rng.integers(0, 1000, n), 0)
    else:
        v = rng.integers(5, 8, n)
    p = np.concatenate([[0], np.cumsum(v), np.full(_PAD_N - n, v.sum())])
    return p.astype(np.float32 if float_dtype else np.int64)


def _jit_vmap(fn, **kw):
    return jax.jit(jax.vmap(functools.partial(fn, **kw)))


@functools.lru_cache(maxsize=None)
def _jax_nicol(m: int, speeds: bool):
    if speeds:
        return jax.jit(jax.vmap(lambda p, s: jax_dev.nicol_optimal_device(
            p, m, s)))
    return jax.jit(jax.vmap(lambda p: jax_dev.nicol_optimal_device(p, m)))


def _rel(loads, sp):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.where(loads > 0, loads / sp, 0.0).max())


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 13])
def test_nicol_optimal_int32_bit_identical(m):
    rng = np.random.default_rng(1104 + m)
    ps = np.stack([_padded_prefix(rng) for _ in range(20)])
    want = _jax_nicol(m, False)(jnp.asarray(ps, jnp.int32))
    got = dev.nicol_optimal_device_impl(torch.from_numpy(ps.astype(np.int32)),
                                        m)
    assert_same(want, got)
    for p, cuts in zip(ps, got[0].numpy()):
        np.testing.assert_array_equal(cuts, oned.nicol_optimal(p, m))


def test_nicol_optimal_single_row_is_a_batch_lane():
    rng = np.random.default_rng(3)
    ps = torch.from_numpy(np.stack([_padded_prefix(rng) for _ in range(8)])
                          .astype(np.int32))
    batched = dev.nicol_optimal_device_impl(ps, 5)
    for s in range(8):
        for a, b in zip(dev.nicol_optimal_device_impl(ps[s], 5), batched):
            assert torch.equal(a, b[s])


@pytest.mark.parametrize("m", [2, 3, 5])
def test_nicol_optimal_speeds_match(m):
    """Capacity-aware 1D: the relative bottleneck within 1e-5 of the
    reference's and of the host engine's; the returned bottleneck is the
    one its cuts realize."""
    rng = np.random.default_rng(7 + m)
    ps = np.stack([_padded_prefix(rng) for _ in range(12)])
    sps = rng.uniform(0.25, 4.0, (12, m))
    sps[:, 0] *= 2.0
    sps[::4, -1] = 0.0                       # a dead position
    sps = np.stack([search.normalize_speeds(s, m) for s in sps])
    want = _jax_nicol(m, True)(jnp.asarray(ps, jnp.int32),
                               jnp.asarray(sps, jnp.float32))
    got = dev.nicol_optimal_device_impl(torch.from_numpy(ps.astype(np.int32)),
                                        m, torch.from_numpy(sps))
    # stronger than the contract (see the docstring), on the lanes where
    # the reference's cuts cover the row (P8: the others fall short of n)
    ok = np.asarray(want[0])[:, -1] == _PAD_N
    assert_same(tuple(np.asarray(w)[ok] for w in want),
                tuple(x[torch.from_numpy(ok)] for x in got))
    assert (got[0][:, -1] == _PAD_N).all()
    for p, sp, cuts, bott in zip(ps, sps, got[0].numpy(), got[1].numpy()):
        rel_d = _rel(np.diff(p[cuts]), sp)
        rel_h = _rel(np.diff(p[oned.nicol_optimal(p, m, speeds=sp)]), sp)
        assert rel_d == pytest.approx(rel_h, rel=1e-5, abs=1e-6)
        assert float(bott) == pytest.approx(rel_d, rel=1e-5, abs=1e-6)
        assert (np.diff(cuts)[sp == 0] == 0).all()


@pytest.mark.parametrize("m", [2, 4, 7])
def test_nicol_optimal_float_boundary(m):
    """Float loads whose sums are not exactly representable (the 1/3
    adversary): the float32 bisection stays within 1e-5 of the host
    optimum, and equals the reference's."""
    rng = np.random.default_rng(23 + m)
    vals = (rng.uniform(0, 1, (10, _PAD_N)) * (1 / 3)).astype(np.float32)
    ps = np.concatenate([np.zeros((10, 1), np.float32),
                         np.cumsum(vals, axis=1, dtype=np.float32)], axis=1)
    want = _jax_nicol(m, False)(jnp.asarray(ps))
    got = dev.nicol_optimal_device_impl(torch.from_numpy(ps), m)
    assert_same(want, got)
    for p, cuts in zip(ps.astype(np.float64), got[0].numpy()):
        best = oned.max_interval_load(p, oned.nicol_optimal(p, m))
        assert oned.max_interval_load(p, cuts) <= best * (1 + 1e-5) + 1e-6


@pytest.mark.parametrize("total,s", [(121, 6.557), (128, 2.9),
                                     (205, 1.3)])
def test_speeds_bound_is_made_feasible(total, s):
    """P8: where the whole load must go to one speed ``s``, the
    reference's float32 bound ``(total / s) * (1 + 1e-9)`` rounds to
    ``total / s`` and ``hi * s`` falls an ulp short of the total: its cuts
    stop short of n and its bottleneck is not the load's.  The port raises
    that bound until it is feasible."""
    p = np.array([0, total // 3, total], np.int32)
    sp = np.array([s, 0.0], np.float32)
    ref_cuts, _ = jax_dev.nicol_optimal_device(jnp.asarray(p), 2,
                                               jnp.asarray(sp))
    assert np.asarray(ref_cuts)[-1] < 2              # the reference's fault
    cuts, bott = dev.nicol_optimal_device_impl(torch.from_numpy(p), 2,
                                               torch.from_numpy(sp))
    assert cuts.tolist() == [0, 2, 2]
    assert float(bott) == pytest.approx(total / s, rel=1e-6)
    host = oned.nicol_optimal(p.astype(np.int64), 2,
                              speeds=sp.astype(np.float64))
    assert host.tolist() == [0, 2, 2]


@pytest.mark.parametrize("total,s", [(121, 6.557), (128, 2.9),
                                     (205, 1.3)])
def test_speeds_bound_is_made_feasible_pq(total, s):
    """P8 in JAG-PQ-OPT's speeds branch: one stripe, whose whole load
    must go to its one live column part.  The row bisection's bound is
    raised until feasible, so the stripe covers the Gamma and the
    bottleneck is the load's; a frame whose bound is feasible beside it
    keeps its own result."""
    A = np.array([[total // 3, total - total // 3]], np.int64)
    g = prefix.prefix_sum_2d(A).astype(np.int32)
    sp = np.array([s, 0.0], np.float32)
    rows, _, cols, lmax = dev.jag_pq_opt_device_impl(
        torch.from_numpy(g), P=1, Q=2, speeds=torch.from_numpy(sp))
    assert rows.tolist() == [0, 1]
    assert cols.tolist() == [[0, 2, 2]]
    assert float(lmax) == pytest.approx(total / s, rel=1e-6)
    fine = prefix.prefix_sum_2d(np.array([[3, 4]], np.int64)).astype(np.int32)
    both = dev.jag_pq_opt_device_impl(
        torch.from_numpy(np.stack([g, fine])), P=1, Q=2,
        speeds=torch.from_numpy(sp))
    alone = dev.jag_pq_opt_device_impl(torch.from_numpy(fine), P=1, Q=2,
                                       speeds=torch.from_numpy(sp))
    assert_same(tuple(x[1] for x in both), alone)


def test_wide_bisect_float_candidates_match_jax():
    """The float32 candidates ``lo + (hi - lo) * fr`` of the float
    bisection round once, as XLA computes them (a fused multiply-add):
    the converged bounds agree bit for bit on 4000 lanes, each closing in
    its own round (a closed lane keeps its interval)."""
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 1e6, 4000).astype(np.float32)
    hi = lo + rng.uniform(1, 1e5, 4000).astype(np.float32)
    thr = lo + rng.uniform(0, 1, 4000).astype(np.float32) * (hi - lo)
    want = jax.jit(jax.vmap(lambda a, b, t: jax_dev.wide_bisect_float_device(
        lambda c: c >= t, a, b)))(lo, hi, thr)
    tt = torch.from_numpy(thr)[:, None]
    got = dev.wide_bisect_float_device(lambda c: c >= tt,
                                       torch.from_numpy(lo),
                                       torch.from_numpy(hi))
    assert_same(want, got)


def test_wide_bisect_float_backstop_and_nan_lanes():
    """``max_rounds`` stops a lane whose interval cannot close, and a NaN
    interval is closed from the start, as under the reference."""
    lo = np.array([0.0, np.nan, 1.0], np.float32)
    hi = np.array([1.0, np.nan, 1e30], np.float32)
    for rounds in (1, 3):
        want = jax.jit(jax.vmap(lambda a, b: jax_dev.wide_bisect_float_device(
            lambda c: c >= 0.5, a, b, max_rounds=rounds)))(lo, hi)
        got = dev.wide_bisect_float_device(
            lambda c: c >= 0.5, torch.from_numpy(lo), torch.from_numpy(hi),
            max_rounds=rounds)
        assert_same(want, got)


def _random_gammas(rng, T, n1, n2, high):
    gs = []
    for t in range(T):
        A = rng.integers(0, high, (n1, n2)).astype(np.int64)
        if t % 3 == 0:
            A[:, rng.integers(0, n2)] = 0    # degenerate column
        if t % 4 == 1:
            A[rng.integers(0, n1)] = 0       # degenerate row
        gs.append(prefix.prefix_sum_2d(A))
    return np.stack(gs)


def _rect_loads(g, rc, cc):
    rc, cc = rc.astype(np.int64), cc.astype(np.int64)
    return (g[rc[1:, None], cc[:, 1:]] - g[rc[:-1, None], cc[:, 1:]]
            - g[rc[1:, None], cc[:, :-1]] + g[rc[:-1, None], cc[:, :-1]])


PQS = [(1, 2), (2, 2), (3, 4), (4, 3), (2, 5)]


@pytest.mark.parametrize("P,Q", PQS)
def test_jag_pq_opt_float32_matches(P, Q):
    rng = np.random.default_rng(11 + P * 7 + Q)
    gs = (_random_gammas(rng, 6, 16, 12, 30) / 7.0).astype(np.float32)
    want = _jit_vmap(jax_dev.jag_pq_opt_device, P=P, Q=Q)(jnp.asarray(gs))
    got = dev.jag_pq_opt_device_impl(torch.from_numpy(gs), P=P, Q=Q)
    assert_same(want, got)
    for t, g in enumerate(gs.astype(np.float64)):
        host = jagged.jag_pq_opt(g, P * Q, P=P, Q=Q,
                                 orient="hor").max_load(g)
        real = _rect_loads(g, got[0][t].numpy(), got[2][t].numpy()).max()
        assert real == pytest.approx(host, rel=1e-5, abs=1e-6)
        assert float(got[3][t]) == pytest.approx(host, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("P,Q", PQS)
def test_jag_pq_opt_speeds_match(P, Q):
    """Capacity-aware JAG-PQ-OPT (a dead part where P*Q > 2): the relative
    bottleneck within 1e-5 of the host solver's, and dead parts get
    zero-width rectangles."""
    rng = np.random.default_rng(31 + P * 7 + Q)
    gs = _random_gammas(rng, 4, 16, 12, 30)
    sp = rng.uniform(0.25, 4.0, P * Q)
    sp[0] *= 2.0
    if P * Q > 2:
        sp[P * Q // 2] = 0.0
    sp = search.normalize_speeds(sp, P * Q)
    want = jax.vmap(lambda g: jax_dev.jag_pq_opt_device(
        g, P=P, Q=Q, speeds=jnp.asarray(sp, jnp.float32)))(
        jnp.asarray(gs, jnp.int32))
    got = dev.jag_pq_opt_device_impl(torch.from_numpy(gs.astype(np.int32)),
                                     P=P, Q=Q, speeds=torch.from_numpy(sp))
    # the cuts equal the reference's; its Lmax moves by an ulp with how
    # XLA fuses the call (under an outer jit or not), so within 1e-5
    assert_same(want[:3], got[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-6)
    for t, g in enumerate(gs):
        loads = _rect_loads(g, got[0][t].numpy(), got[2][t].numpy()).ravel()
        host = jagged.jag_pq_opt(g, P * Q, P=P, Q=Q, orient="hor",
                                 speeds=sp)
        want_rel = _rel(host.loads(g).astype(np.float64), sp)
        assert _rel(loads, sp) == pytest.approx(want_rel, rel=1e-5, abs=1e-6)
        assert (loads[sp == 0] == 0).all()


@pytest.mark.parametrize("m", [2, 3, 5])
def test_jag_m_opt_int32_bit_identical(m):
    """All five outputs equal the reference's, and the bottleneck equals
    the host DP's."""
    rng = np.random.default_rng(19 + m)
    gs = _random_gammas(rng, 8, 12, 10, 25)
    want = _jit_vmap(jax_dev.jag_m_opt_device, m=m)(jnp.asarray(gs,
                                                                jnp.int32))
    got = dev.jag_m_opt_device_impl(torch.from_numpy(gs.astype(np.int32)),
                                    m=m)
    assert_same(want, got)
    for t, g in enumerate(gs):
        host = jagged.jag_m_opt(g, m, orient="hor").max_load(g)
        assert int(got[4][t]) == int(host)
        assert int(got[1][t][:int(got[3][t])].sum()) == m


@pytest.mark.parametrize("m", [2, 4])
def test_jag_m_opt_float32_matches(m):
    rng = np.random.default_rng(41 + m)
    gs = (_random_gammas(rng, 4, 12, 10, 25) / 3.0).astype(np.float32)
    want = _jit_vmap(jax_dev.jag_m_opt_device, m=m)(jnp.asarray(gs))
    got = dev.jag_m_opt_device_impl(torch.from_numpy(gs), m=m)
    assert_same(want, got)
    for t, g in enumerate(gs.astype(np.float64)):
        host = jagged.jag_m_opt(g, m, orient="hor").max_load(g)
        assert float(got[4][t]) == pytest.approx(host, rel=1e-5, abs=1e-6)


def test_jag_m_opt_single_gamma_is_a_batch_lane():
    rng = np.random.default_rng(5)
    gs = torch.from_numpy(_random_gammas(rng, 3, 9, 7, 20).astype(np.int32))
    batched = dev.jag_m_opt_device_impl(gs, m=4)
    for t in range(3):
        for a, b in zip(dev.jag_m_opt_device_impl(gs[t], m=4), batched):
            assert torch.equal(a, b[t])


@pytest.mark.parametrize("total", [2 ** 30, 2 ** 31 - 1])
def test_int32_totals_from_2_30_are_refused(total):
    """P7: the exact solvers refuse int32 totals in [2**30, 2**31) (the
    reference's greedy target ``p[pos] + L`` can wrap there) instead of
    wrapping; the registry refuses totals from 2**31 as the reference
    does."""
    from repro_torch.core import registry
    A = np.zeros((4, 4), np.int64)
    A[0, 0] = total - 15
    A[1:, 1:] = 0
    A[3, 3] = 15
    g = prefix.prefix_sum_2d(A)
    assert g[-1, -1] == total
    gt = torch.from_numpy(g.astype(np.int32))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        dev.jag_pq_opt_device_impl(gt, P=2, Q=2)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        dev.jag_m_opt_device_impl(gt, m=4)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        dev.nicol_optimal_device_impl(gt[:, -1].contiguous(), 3)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        registry.partition("jag-pq-opt-device", g, 4, device="cpu")
    A[3, 3] += 2 ** 31 - total
    with pytest.raises(ValueError, match="overflows"):
        registry.partition("jag-m-opt-device", prefix.prefix_sum_2d(A), 4,
                           device="cpu")


def test_exact_solvers_take_int32_or_float32():
    g = torch.from_numpy(prefix.prefix_sum_2d(np.ones((5, 5), np.int64)))
    for call in (lambda x: dev.jag_pq_opt_device_impl(x, P=2, Q=2),
                 lambda x: dev.jag_m_opt_device_impl(x, m=3),
                 lambda x: dev.nicol_optimal_device_impl(x[:, -1], 3)):
        for dtype in (torch.int64, torch.float64):
            with pytest.raises(TypeError):
                call(g.to(dtype))
