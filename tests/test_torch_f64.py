"""The heuristic planner on float64 accumulators: the port against the JAX
package under ``jax.enable_x64()``, on the CPU.

- ``core.device._fma_f64`` (the candidates' fused multiply-add, emulated)
  against exact rational arithmetic (``fractions.Fraction``);
- ``wide_bisect_device``'s float64 candidates, ``jag_m_heur_device_impl``
  and ``planner.plan_host(gamma_dtype=float64)`` bit for bit against the
  reference's own functions (tolerance: none), on integer loads above
  2**24, where float32 would drift;
- their Lmax against the exact int64 bottleneck of their own plans;
- the accumulator default on a floating Gamma (the Gamma's own dtype).

K1 in float64 against its plain version runs on the card
(``test_torch_card.py``); here the plain version is held to the
reference's SAT under x64.
"""
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.core import device as jax_dev
from repro.kernels.sat import ops as jax_sat
from repro.rebalance import planner as jax_planner
from repro.rebalance import stream as jax_stream
from repro_torch.core import device as dev
from repro_torch.core import prefix
from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.rebalance import batch_device, planner


def _exact_fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` rounded once (Python's int division rounds
    correctly, half to even)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _edge_triples() -> list:
    u = 2.0 ** -52
    return [
        (2.0 ** -27, 2.0 ** -26, 1.0),            # tie: 1 + 2**-53 -> 1
        (3.0 * 2.0 ** -27, 2.0 ** -26, 1.0),      # tie: 1 + 3*2**-53 -> up
        (2.0 ** -53 + 2.0 ** -80, 1.0, 1.0),      # just past a tie
        (2.0 ** -53 - 2.0 ** -80, 1.0, 1.0),      # just below a tie
        (-(2.0 ** -53 + 2.0 ** -80), 1.0, 1.0),
        (1.0 + u, 1.0 - u, -1.0),                 # cancellation: -u**2
        (1.0 + u, 1.0 + u, -(1.0 + 2 * u)),       # exact: u**2
        (0.1, 10.0, -1.0),                        # the product's error only
        (-3.0, 7.0, 21.0),                        # exact zero
        (1e100 + 1e84, 3e99, -3e199),             # large, cancelling
        (123456789.0, 987654321.0, -1.2193263111263526e17),
        (7.0, 0.7777777777777778, 5.5e8),         # a candidate's shape
        (0.0, 5.0, -2.5),
        (-1.5, -2.5, 0.25),
    ]


def test_fma_f64_is_correctly_rounded():
    """Random triples of every sign and scale, and the edge triples
    (ties, just past them, cancellation, exact zeros, large values):
    equal to the exactly rounded ``a * b + c``."""
    rng = np.random.default_rng(0)
    n = 4000
    scale = 10.0 ** rng.integers(-30, 30, (3, n))
    a, b, c = rng.standard_normal((3, n)) * scale
    edge = np.array(_edge_triples()).T
    a, b, c = (np.concatenate([x, e]) for x, e in zip((a, b, c), edge))
    got = dev._fma_f64(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    # the unfused expression is not the same function
    assert (a * b + c != want).sum() > 100


def test_fma_f64_on_the_bisection_schedule():
    """Triples shaped as the candidate schedule makes them: (hi - lo),
    i * fl(1/9), lo for loads up to 2**40."""
    rng = np.random.default_rng(1)
    lo = rng.integers(0, 2 ** 40, 3000).astype(np.float64)
    span = rng.uniform(1, 2 ** 30, 3000)
    fr = np.arange(1, 9) * (1.0 / 9)
    got = dev._fma_f64(torch.from_numpy(span)[:, None],
                       torch.from_numpy(fr)[None],
                       torch.from_numpy(lo)[:, None])
    want = np.array([[_exact_fma(s, f, x) for f in fr]
                     for s, x in zip(span, lo)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,k", [(np.float64, 8), (np.float64, 5),
                                     (np.float64, 15), (np.float32, 5),
                                     (np.float32, 8)])
def test_wide_bisect_candidates_match_jax(dtype, k):
    """The bisection brackets bit for bit on 4000 lanes.  The reference's
    candidates are ``lo + (hi - lo) * fr`` fused by XLA, with ``fr = i *
    fl(1/(k+1))`` (XLA turns the division by ``k+1`` into a product by
    its reciprocal: float64 k=8 and float32 k=5 are where the two
    differ, P9)."""
    rng = np.random.default_rng(k)
    with jax.enable_x64():
        lo = rng.uniform(0, 1e9, 4000).astype(dtype)
        hi = (lo + rng.uniform(1, 1e7, 4000)).astype(dtype)
        thr = (lo + rng.uniform(0, 1, 4000) * (hi - lo)).astype(dtype)
        want = jax.jit(jax.vmap(lambda a, b, t: jax_dev.wide_bisect_device(
            lambda Ls: Ls >= t, a, b, k=k, rounds=4)))(lo, hi, thr)
        tt = torch.from_numpy(thr)[:, None]
        got = dev.wide_bisect_device(lambda Ls: Ls >= tt, torch.from_numpy(lo),
                                     torch.from_numpy(hi), k=k, rounds=4)
        assert_same(want, got)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_candidate_fractions_are_the_reciprocal_products(dtype):
    with jax.enable_x64():
        for k in (1, 5, 8, 15):
            want = jax.jit(lambda: jnp.arange(1, k + 1, dtype=dtype)
                           / (k + 1))()
            got = dev._fractions(k, torch.zeros((), dtype=getattr(
                torch, np.dtype(dtype).name)))
            np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _f3_instance() -> np.ndarray:
    """The reference's F3 instance: 24x24 loads in [2**20, 2**22), a frame
    total near 1.7e9, far above 2**24."""
    return np.random.default_rng(0).integers(1 << 20, 1 << 22, (24, 24))


def _plan_loads_max(out, g: np.ndarray, shape) -> float:
    rc, ct, cc, _ = (x.numpy() for x in out)
    return float(batch_device.Plan(rc, ct, cc, shape).loads(g).max())


def test_jag_m_heur_f64_on_the_f3_instance():
    """P=3, m=8 on the F3 instance: cuts, counts and Lmax bit-identical to
    the reference's ``jag_m_heur_device(gamma_dtype=float64)``, and Lmax
    equal to the exact int64 bottleneck of the plan (the contract the
    reference's own F3 test states)."""
    a = _f3_instance()
    g = prefix.prefix_sum_2d(a)
    with jax.enable_x64():
        want = jax_dev.jag_m_heur_device(jnp.asarray(g, jnp.float64), P=3,
                                         m=8, gamma_dtype=jnp.float64)
    got = dev.jag_m_heur_device_impl(torch.from_numpy(g.astype(np.float64)),
                                     P=3, m=8, gamma_dtype=torch.float64)
    assert_same(want, got)
    assert float(got[3]) == _plan_loads_max(got, g, a.shape)


def _pic_above_2_24(T=3, n1=40, n2=48) -> np.ndarray:
    fr = jax_stream.pic_series(T, n1, n2, seed=1) * 2 ** 10
    assert fr.reshape(T, -1).sum(axis=1).min() > 2 ** 24
    return fr


_JAX_HEUR64 = functools.partial(jax_dev.jag_m_heur_device_impl, P=4, m=16,
                                gamma_dtype=jnp.float64)


def test_jag_m_heur_f64_on_the_pic_stream():
    """The PIC series scaled past 2**24 (totals near 4e9): every frame
    bit-identical to the reference's float64 heuristic, and Lmax = the
    exact int64 bottleneck of its plan."""
    fr = _pic_above_2_24()
    gs = np.stack([prefix.prefix_sum_2d(f) for f in fr])
    with jax.enable_x64():
        want = jax.jit(jax.vmap(_JAX_HEUR64))(jnp.asarray(gs, jnp.float64))
    got = dev.jag_m_heur_device_impl(torch.from_numpy(gs.astype(np.float64)),
                                     P=4, m=16, gamma_dtype=torch.float64)
    assert_same(want, got)
    for t in range(fr.shape[0]):
        one = tuple(x[t] for x in got)
        assert float(one[3]) == _plan_loads_max(one, gs[t], fr.shape[1:])


def test_default_accumulator_follows_a_floating_gamma():
    """``gamma_dtype=None`` takes the Gamma's own dtype when it is
    floating, else float32, as the reference does.  On a float64 Gamma
    the port used float32 before (a float32 Lmax where the reference
    returns a float64 one, and other cuts); on an int32 Gamma both use
    float32."""
    a = _f3_instance()
    g = prefix.prefix_sum_2d(a)
    with jax.enable_x64():
        want64 = jax_dev.jag_m_heur_device(jnp.asarray(g, jnp.float64), P=3,
                                           m=8)
        want32 = jax_dev.jag_m_heur_device(jnp.asarray(g // 256, jnp.int32),
                                           P=3, m=8)
    got64 = dev.jag_m_heur_device_impl(torch.from_numpy(g.astype(np.float64)),
                                       P=3, m=8)
    assert got64[3].dtype == torch.float64
    assert_same(want64, got64)
    got32 = dev.jag_m_heur_device_impl(
        torch.from_numpy((g // 256).astype(np.int32)), P=3, m=8)
    assert got32[3].dtype == torch.float32
    assert_same(want32, got32)
    # the planner keeps its explicit float32 default
    assert planner.resolve_gamma_dtype(None, exact=False) == torch.float32
    assert planner.resolve_gamma_dtype(None, exact=True) == torch.int32


@pytest.mark.parametrize("T,n1,n2,P,m", [(3, 40, 48, 4, 16),
                                         (2, 24, 24, 3, 8)])
def test_plan_host_f64_matches_jax(T, n1, n2, P, m):
    """``planner.plan_host(gamma_dtype=float64)`` on the CPU: the ingest
    casts to float64 before K1's plain version, and the plans equal the
    reference's ``plan_host(gamma_dtype=float64)`` under x64."""
    fr = _pic_above_2_24(T, n1, n2)
    with jax.enable_x64():
        want = jax_planner.plan_host(fr, P=P, m=m, gamma_dtype=jnp.float64)
    got = planner.plan_host(fr, P=P, m=m, gamma_dtype=torch.float64,
                            device="cpu")
    for x, y in zip(want, got):
        for f in ("row_cuts", "counts", "col_cuts"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    batched = planner.plan_stream(fr, P=P, m=m, gamma_dtype=torch.float64,
                                  device="cpu")
    assert batched[3].dtype == torch.float64
    for t, pl in enumerate(got):
        g = prefix.prefix_sum_2d(fr[t])
        pl.validate(g, m=m)
        assert float(batched[3][t]) == pl.max_load(g)


def test_gamma_f64_matches_jax():
    """K1's plain version on float64 frames = the reference's SAT under
    x64 (its plain route and its Pallas kernel in interpret mode)."""
    a = _pic_above_2_24(2, 17, 33).astype(np.float64)
    got = sat_ops.gamma(torch.from_numpy(a))
    with jax.enable_x64():
        for use_pallas in (False, True):
            assert_same(jax_sat.gamma(jnp.asarray(a), use_pallas=use_pallas,
                                      interpret=True), got)
