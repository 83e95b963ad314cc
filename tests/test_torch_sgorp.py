"""SGORP parity: the port's ``repro_torch.core.sgorp`` against the JAX
package's ``repro.core.sgorp`` on the CPU.

The reference runs one ``lax.while_loop`` per frame under ``vmap``; the
port writes the frame axis out.  Every comparison here is bit for bit
(tolerance: none) — cuts, Lmax, iterations and projections — on integer
loads, float32 Gamma below 2**24 and int32 Gamma (the int32 warm start
also above 2**24, where both packages search in float32).  The reference
runs jitted, as its planner runs it (XLA fuses the float32 bisection
candidates into a multiply-add there; see ROADMAP P1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.core import sgorp as jsg
from repro.obs.counters import C as JC
from repro.rebalance import stream as jstream
from repro_torch.core import prefix, sgorp
from repro_torch.kernels.sat import ref as sat_ref
from repro_torch.obs.counters import C as TC
from repro_torch.rebalance import stream

CPU = torch.device("cpu")
DT = {"float32": (jnp.float32, torch.float32),
      "int32": (jnp.int32, torch.int32)}
# (stream, (n1, n2, n3)): cubic and non-cubic volumes, T=4
CASES = [("pic3d", (12, 12, 12)), ("amr3d", (16, 16, 16)),
         ("pic3d", (10, 12, 14)), ("amr3d", (10, 12, 14))]


def _gammas(name, shape, dtype, T=4, seed=0, scale=1):
    """The same Gamma3 batch for both packages (numpy)."""
    fr = stream.STREAMS_3D[name](T, *shape, seed=seed) * scale
    g = sat_ref.gamma3_ref(torch.from_numpy(fr).to(DT[dtype][1]))
    return g.numpy()


@functools.lru_cache(maxsize=None)
def _jax_warm(grid):
    return jax.jit(jax.vmap(lambda g: jsg.warm_start_impl(g, grid=grid)))


@functools.lru_cache(maxsize=None)
def _jax_refine(grid):
    def one(g, sg, *warm):
        return jsg.sgorp_refine_impl(g, warm, sg, grid=grid)
    return jax.jit(jax.vmap(one, in_axes=(0, None) + (0,) * len(grid)))


@functools.lru_cache(maxsize=None)
def _jax_plan3d(grid, dtype):
    return jax.jit(functools.partial(jsg.sgorp_plan_3d_impl, grid=grid,
                                     gamma_dtype=DT[dtype][0]))


def _flat(out):
    """(cuts tuple, L, it, pr) -> one flat tuple."""
    return tuple(out[0]) + tuple(out[1:])


# ---------------------------------------------------------------------------
# host-side helpers


@pytest.mark.parametrize("shape", [(64, 64, 64), (16, 16, 16), (8, 8, 8),
                                   (32, 32), (5, 40, 3), (2, 2, 2), (7,)])
def test_default_grid_matches_jax(shape):
    for m in range(1, 65):
        try:
            want = jsg.default_grid(m, shape)
        except ValueError as e:
            with pytest.raises(ValueError, match="prime factor"):
                sgorp.default_grid(m, shape)
            assert "prime factor" in str(e)
            continue
        assert sgorp.default_grid(m, shape) == want


@pytest.mark.parametrize("n", [1, 7, 30])
def test_project_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-3, n + 3, (6, 5)).astype(np.float32)
    x[0] = [0.5, 1.5, 2.5, -0.5, n + 0.5]       # halves round to even
    want = jax.vmap(lambda v: jsg._project(v, n))(jnp.asarray(x))
    assert_same(want, sgorp._project(torch.from_numpy(x), n))


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("d", [2, 3])
def test_cell_loads_match_jax(dtype, d):
    rng = np.random.default_rng(d)
    shape = (9, 11, 6)[:d]
    a = rng.integers(0, 1000, (3,) + shape)
    g = np.zeros((3,) + tuple(n + 1 for n in shape), np.int64)
    g[(slice(None),) + (slice(1, None),) * d] = (
        a.cumsum(1).cumsum(2).cumsum(3) if d == 3 else a.cumsum(1).cumsum(2))
    g = g.astype(dtype)
    ics = [np.stack([np.r_[0, np.sort(rng.integers(0, n + 1, 3)), n]
                     for _ in range(3)]).astype(np.int32) for n in shape]
    want = jax.vmap(lambda gg, *ic: jsg._cell_loads(gg, ic))(
        jnp.asarray(g), *map(jnp.asarray, ics))
    got = sgorp._cell_loads(torch.from_numpy(g),
                            [torch.from_numpy(ic) for ic in ics])
    assert_same(want, got)


# ---------------------------------------------------------------------------
# the device functions, batched over frames


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("m", [8, 12, 27])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_warm_start_and_refine_match_jax(case, m, dtype):
    g = _gammas(*case, dtype)
    grid = jsg.default_grid(m, case[1])
    warm_j = _jax_warm(grid)(jnp.asarray(g))
    warm_t = sgorp.warm_start_impl(torch.from_numpy(g), grid=grid)
    assert_same(warm_j, warm_t)
    ref_j = _jax_refine(grid)(jnp.asarray(g), None, *warm_j)
    ref_t = sgorp.sgorp_refine_impl(torch.from_numpy(g), warm_t, grid=grid)
    assert_same(_flat(ref_j), _flat(ref_t))


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("m", [8, 12, 27])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_plan_3d_matches_jax(case, m, dtype):
    name, shape = case
    fr = stream.STREAMS_3D[name](4, *shape, seed=1)
    grid = jsg.default_grid(m, shape)
    want = _jax_plan3d(grid, dtype)(jnp.asarray(fr))
    got = sgorp.sgorp_plan_3d_impl(torch.from_numpy(fr), grid=grid,
                                   gamma_dtype=DT[dtype][1])
    assert_same(want, got)
    # refined never worse than the warm start
    g = torch.from_numpy(_gammas(name, shape, dtype, seed=1))
    warm = sgorp.warm_start_impl(g, grid=grid)
    _, warm_L, _, _ = sgorp.sgorp_refine_impl(g, warm, grid=grid,
                                              max_iters=1)
    assert (got[3] <= warm_L).all()


def test_plan_3d_through_the_pallas_kernel_matches_jax():
    fr = stream.pic_series_3d(2, 10, 12, 14, seed=2)
    grid = jsg.default_grid(12, fr.shape[1:])
    want = jax.jit(functools.partial(
        jsg.sgorp_plan_3d_impl, grid=grid, use_pallas=True,
        interpret=True))(jnp.asarray(fr))
    assert_same(want, sgorp.sgorp_plan_3d_impl(torch.from_numpy(fr),
                                               grid=grid))


def test_lanes_that_stop_early_keep_their_carry():
    """A uniform frame stops after ``patience`` iterations while a PIC
    frame (totals above 2**24, int32 and float32 alike) runs on: each
    lane's carry, counts included, equals the reference's."""
    pic = stream.pic_series_3d(2, 24, 24, 24)[1] * 10
    fr = np.stack([np.full_like(pic, 7), pic])
    grid = jsg.default_grid(64, pic.shape)
    for dtype in DT:
        want = _jax_plan3d(grid, dtype)(jnp.asarray(fr))
        got = sgorp.sgorp_plan_3d_impl(torch.from_numpy(fr), grid=grid,
                                       gamma_dtype=DT[dtype][1])
        assert_same(want, got)
        iters = got[4].tolist()
        assert iters[0] == 33 and iters[1] > iters[0]


@pytest.mark.parametrize("dtype", list(DT))
def test_warm_start_above_2_24_matches_jax(dtype):
    """The warm start's margin prefixes exceed 2**24: on an int32 Gamma
    both packages compare them with float32 targets (searchsorted promotes
    the int32 prefix), so the cuts agree bit for bit."""
    g = _gammas("pic3d", (24, 24, 24), dtype, T=2, scale=10)
    assert int(g[0, -1, -1, -1]) > 2 ** 24
    grid = jsg.default_grid(64, (24, 24, 24))
    assert_same(_jax_warm(grid)(jnp.asarray(g)),
                sgorp.warm_start_impl(torch.from_numpy(g), grid=grid))


def test_refine_with_speeds_matches_jax():
    g = _gammas("amr3d", (12, 12, 12), "float32", seed=4)
    grid = (2, 2, 2)
    sg = np.random.default_rng(3).uniform(0.3, 3.0, grid).astype(np.float32)
    warm = sgorp.warm_start_impl(torch.from_numpy(g), grid=grid)
    want = _jax_refine(grid)(jnp.asarray(g), jnp.asarray(sg),
                             *[jnp.asarray(w.numpy()) for w in warm])
    got = sgorp.sgorp_refine_impl(torch.from_numpy(g), warm,
                                  torch.from_numpy(sg), grid=grid)
    assert_same(_flat(want), _flat(got))


def test_standalone_refine_matches_jax():
    g = _gammas("pic3d", (12, 12, 12), "float32")[0]
    grid = (2, 3, 2)
    warm = [w[0] for w in sgorp.warm_start_impl(torch.from_numpy(g)[None],
                                                grid=grid)]
    want = jsg.sgorp_refine(jnp.asarray(g),
                            tuple(jnp.asarray(w.numpy()) for w in warm),
                            grid=grid, max_iters=50, patience=8)
    got = sgorp.sgorp_refine(torch.from_numpy(g), warm, grid=grid,
                             max_iters=50, patience=8)
    assert_same(_flat(want), _flat(got))


# ---------------------------------------------------------------------------
# host entries


def _boxes(part):
    return [dataclasses.astuple(b) for b in getattr(part, "boxes", None)
            or part.rects]


SPEEDS = {"none": None, "ints": np.array([1, 1, 2, 2, 1, 3, 1, 1], float),
          "random": np.random.default_rng(5).uniform(0.3, 3.0, 8)}


@pytest.mark.parametrize("speeds", list(SPEEDS))
def test_sgorp_3d_matches_jax(speeds):
    A = prefix.pic_like_instance_3d(12, 12, 12, seed=3)
    JC.reset()
    TC.reset()
    want = jsg.sgorp_3d(A, 8, speeds=SPEEDS[speeds])
    got = sgorp.sgorp_3d(A, 8, speeds=SPEEDS[speeds], device=CPU)
    assert _boxes(got) == _boxes(want)
    assert got.is_valid() and got.shape == want.shape
    assert (TC.sgorp_iterations, TC.sgorp_projections) == (
        JC.sgorp_iterations, JC.sgorp_projections)
    assert TC.sgorp_iterations > 0


@pytest.mark.parametrize("speeds", ["none", "random"])
@pytest.mark.parametrize("loads", ["int", "float"])
def test_sgorp_2d_matches_jax(speeds, loads):
    A2 = prefix.pic_like_instance(24, 24, seed=1)
    g2 = prefix.prefix_sum_2d(A2 if loads == "int" else A2 * 0.5)
    sp = None if speeds == "none" else \
        np.random.default_rng(6).uniform(0.3, 3.0, 12)
    JC.reset()
    TC.reset()
    want = jsg.sgorp_2d(g2, 12, speeds=sp)
    got = sgorp.sgorp_2d(g2, 12, speeds=sp, device=CPU)
    assert _boxes(got) == _boxes(want)
    assert got.is_valid()
    assert TC.sgorp_iterations == JC.sgorp_iterations > 0
    assert TC.sgorp_projections == JC.sgorp_projections


@pytest.mark.parametrize("kwargs,match", [
    ({"speeds": np.array([1, 1, 0, 1, 1, 1, 1, 1.0])}, "strictly positive"),
    ({"grid": (2, 2, 3)}, "12 cells"),
    ({"grid": (8, 1, 1)}, "exceeds shape"),
])
def test_host_entries_refuse_like_jax(kwargs, match):
    A = prefix.amr_like_instance_3d(6, 6, 6)
    with pytest.raises(ValueError, match=match):
        jsg.sgorp_3d(A, 8, **kwargs)
    with pytest.raises(ValueError, match=match):
        sgorp.sgorp_3d(A, 8, device=CPU, **kwargs)


def test_int32_overflow_guard_matches_jax():
    g = np.zeros((3, 3), np.int64)
    g[-1, -1] = 2 ** 31
    with pytest.raises(ValueError, match="overflows"):
        jsg.sgorp_2d(g, 2)
    with pytest.raises(ValueError, match="overflows"):
        sgorp.sgorp_2d(g, 2, device=CPU)


def test_streams_3d_match_jax():
    for name, fn in stream.STREAMS_3D.items():
        np.testing.assert_array_equal(
            fn(3, 7, 9, 11, seed=4), jstream.STREAMS_3D[name](3, 7, 9, 11,
                                                            seed=4))
