"""Parity of the port's device partitioners (``repro_torch.core.device``)
with the JAX package's, on the CPU.

Inputs are the ``STREAMS`` generators at a small size, made from a seed
with NumPy and handed to both packages.  Tolerance: none.  The heuristic
runs on float32 Gammas whose frame totals stay below 2**24; the exact
JAG-PQ-OPT on int32.  The JAX exact solver runs with its probe on the
Pallas kernel (interpret mode) and on its plain scan.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.core import device as jax_dev
from repro.kernels.sat import ops as jax_sat
from repro.rebalance import stream as jax_stream
from repro_torch.core import device as dev
from repro_torch.kernels.sat import ops as sat_ops

T, N1, N2, P, M = 3, 37, 53, 4, 16
STREAMS = sorted(jax_stream.STREAMS)


@functools.lru_cache(maxsize=None)
def _frames(name: str) -> np.ndarray:
    fr = jax_stream.STREAMS[name](T, N1, N2, seed=3)
    assert fr.reshape(T, -1).sum(axis=1).max() < 2 ** 24
    return fr


def _gammas(name: str, exact: bool):
    fr = _frames(name)
    gj = jax_sat.gamma(jnp.asarray(fr, jnp.int32 if exact else jnp.float32),
                       use_pallas=False)
    return gj, torch.from_numpy(np.array(gj))


# the reference solvers vmapped over frames, jitted once for every stream
_JAX_HEUR = jax.jit(jax.vmap(functools.partial(
    jax_dev.jag_m_heur_device_impl, P=P, m=M)))
_JAX_PQ = {use_pallas: jax.jit(jax.vmap(functools.partial(
    jax_dev.jag_pq_opt_device_impl, P=P, Q=M // P, k=8,
    use_pallas_probe=use_pallas, interpret=True)))
    for use_pallas in (True, False)}


@pytest.mark.parametrize("name", STREAMS)
def test_jag_m_heur_matches_jax(name):
    gj, gt = _gammas(name, exact=False)
    assert_same(_JAX_HEUR(gj), dev.jag_m_heur_device_impl(gt, P=P, m=M))


@pytest.mark.parametrize("name", STREAMS)
def test_jag_pq_opt_matches_jax(name):
    gj, gt = _gammas(name, exact=True)
    got = dev.jag_pq_opt_device_impl(gt, P=P, Q=M // P, k=8)
    for use_pallas in (True, False):
        assert_same(_JAX_PQ[use_pallas](gj), got)


@pytest.mark.parametrize("exact", [False, True])
def test_single_gamma_matches_batch(exact):
    _, gt = _gammas("pic", exact)
    if exact:
        one = functools.partial(dev.jag_pq_opt_device_impl, P=P, Q=M // P)
    else:
        one = functools.partial(dev.jag_m_heur_device_impl, P=P, m=M)
    batched = one(gt)
    for t in range(T):
        for a, b in zip(one(gt[t]), batched):
            assert torch.equal(a, b[t])


@pytest.mark.parametrize("m", [1, 3, 8])
def test_optimal_1d_matches_jax(m):
    rng = np.random.default_rng(m)
    rows = np.zeros((4, 41), np.float32)
    rows[:, 1:] = np.cumsum(rng.integers(0, 1000, (4, 40)), axis=1)
    want = jax.vmap(lambda p: jax_dev.optimal_1d_device(p, m))(
        jnp.asarray(rows))
    assert_same(want, dev.optimal_1d_device(torch.from_numpy(rows), m))


def test_wide_bisect_candidates_match_jax():
    """The float32 candidates ``lo + (hi - lo) * fr`` round once, as XLA
    computes them (a fused multiply-add): the bisection brackets agree
    bit for bit on 4000 lanes."""
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 1e6, 4000).astype(np.float32)
    hi = lo + rng.uniform(1, 1e5, 4000).astype(np.float32)
    thr = (lo + rng.uniform(0, 1, 4000).astype(np.float32) * (hi - lo))
    want = jax.jit(jax.vmap(lambda a, b, t: jax_dev.wide_bisect_device(
        lambda Ls: Ls >= t, a, b, rounds=3)))(lo, hi, thr)
    tt = torch.from_numpy(thr)[:, None]
    got = dev.wide_bisect_device(lambda Ls: Ls >= tt, torch.from_numpy(lo),
                                 torch.from_numpy(hi), rounds=3)
    assert_same(want, got)


def test_exact_helpers_match_jax():
    rng = np.random.default_rng(1)
    p = np.zeros((5, 30), np.int32)
    p[:, 1:] = np.cumsum(rng.integers(0, 50, (5, 29)), axis=1)
    pt = torch.from_numpy(p)
    lo, hi = jax.vmap(lambda r: jax_dev._exact_1d_bounds_int(r, 4))(p)
    assert_same((lo, hi), dev._exact_1d_bounds_int(pt, 4))
    L = jax.vmap(lambda r, a, b: jax_dev.wide_bisect_exact_device(
        lambda c: jax_dev.probe_device(r, 4, c), a, b, k=5))(p, lo, hi)
    Lt = dev.wide_bisect_exact_device(
        lambda c: dev.probe_device(pt, 4, c), torch.from_numpy(np.array(lo)),
        torch.from_numpy(np.array(hi)), k=5)
    assert_same(L, Lt)
    assert_same(jax.vmap(lambda r, l: jax_dev._greedy_cuts_exact(r, 4, l))(
        p, L), dev._greedy_cuts_exact(pt, 4, Lt))
    cuts = jax.vmap(lambda r, l: jax_dev.probe_cuts_device(r, 4, l))(p, L)
    assert_same(cuts, dev.probe_cuts_device(pt, 4, Lt))


def test_unported_branches_raise():
    """The heuristic takes float32 and float64 accumulators and refuses
    others; the exact solvers take int32 or float32 and refuse other
    dtypes."""
    _, gi = _gammas("static", exact=True)
    _, gf = _gammas("static", exact=False)
    with pytest.raises(TypeError):
        dev.jag_pq_opt_device_impl(gi.long(), P=2, Q=2)
    for gd in (torch.float16, torch.int32):
        with pytest.raises(NotImplementedError):
            dev.jag_m_heur_device_impl(gf, P=2, m=4, gamma_dtype=gd)


def test_exact_refuses_totals_above_2_30():
    g = sat_ops.gamma(torch.full((1, 4, 4), 2 ** 26, dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*30"):
        dev.jag_pq_opt_device_impl(g, P=2, Q=2)


@pytest.mark.parametrize("n2,m", [(0, 1), (7, 3)])
def test_collapse_cuts_match_jax(n2, m):
    assert_same(jax_dev._collapse_cuts(n2, m), dev._collapse_cuts(n2, m))
