"""Parity of the port's 3D frame planner (``planner.plan_stream_3d`` and
the rank-4 route of ``planner.plan_stream``) with the JAX package's, end
to end on the CPU, plus the NumPy copies it stands on (3D prefix helpers,
3D streams, ``Partition3D``) and ``Plan.to_partition``.

Both packages get the same ``STREAMS_3D`` volumes (T=4, made from a seed
with NumPy).  The JAX planner runs on its plain version and with its
Pallas kernel in interpret mode.  Tolerance: none — frame totals stay
below 2**24 and both gamma dtypes must agree bit for bit.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same, jax_plans_from_torch,
                           torch_plans_from_jax)
from repro.core import prefix as jax_prefix
from repro.core import threed as jax_threed
from repro.rebalance import planner as jax_planner
from repro.rebalance import stream as jax_stream
from repro_torch.core import prefix, threed
from repro_torch.rebalance import planner, stream

CPU = "cpu"
DT = {"float32": (jnp.float32, torch.float32),
      "int32": (jnp.int32, torch.int32)}
# (stream, (n1, n2, n3), m)
CASES = [("pic3d", (12, 12, 12), 8), ("amr3d", (16, 14, 12), 12),
         ("pic3d", (10, 12, 14), 27), ("amr3d", (12, 12, 12), 18)]


@functools.lru_cache(maxsize=None)
def _frames(name, shape):
    return stream.STREAMS_3D[name](4, *shape, seed=2)


@functools.lru_cache(maxsize=None)
def _jax_plan(name, shape, m, dtype, use_pallas):
    out = jax_planner.plan_stream_3d(_frames(name, shape), m=m,
                                     gamma_dtype=DT[dtype][0],
                                     use_pallas=use_pallas, interpret=True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-m{c[2]}")
def test_plan_stream_3d_matches_jax(case, dtype):
    name, shape, m = case
    fr = _frames(name, shape)
    got = planner.plan_stream_3d(fr, m=m, gamma_dtype=DT[dtype][1],
                                 device=CPU)
    assert_same(_jax_plan(name, shape, m, dtype, False), got)
    # rank-4 frames through plan_stream take the same route (P ignored)
    assert_same(got, planner.plan_stream(fr, P=3, m=m,
                                         gamma_dtype=DT[dtype][1],
                                         device=CPU))
    # every frame's cuts are a valid rectilinear partition
    for t in range(fr.shape[0]):
        part = threed.partition3d_from_grid(*(c[t].numpy() for c in got[:3]),
                                            shape=shape)
        assert part.is_valid() and len(part.boxes) == m
        g3 = prefix.prefix_sum_3d(fr[t])
        assert part.loads(fr[t], gamma3=g3).sum() == g3[-1, -1, -1]
        if dtype == "int32":
            assert part.max_load(fr[t], gamma3=g3) == float(got[3][t])


def test_plan_stream_3d_matches_jax_pallas_route():
    name, shape, m = CASES[1]
    got = planner.plan_stream(_frames(name, shape), P=0, m=m, device=CPU)
    assert_same(_jax_plan(name, shape, m, "float32", True), got)


def test_plan_stream_3d_explicit_grid_and_tensor_input():
    fr = _frames("pic3d", (12, 12, 12))
    want = jax_planner.plan_stream_3d(fr, m=12, grid=(1, 3, 4))
    got = planner.plan_stream_3d(torch.from_numpy(fr), m=12, grid=(1, 3, 4),
                                 device=CPU)
    assert_same(tuple(np.asarray(x) for x in want), got)
    assert tuple(got[0].shape) == (4, 2) and tuple(got[2].shape) == (4, 5)


@pytest.mark.parametrize("fn,kwargs,rank,match", [
    ("plan_stream", {"P": 2, "m": 8, "exact": True}, 4, "exact=True"),
    ("plan_stream_3d", {"m": 8}, 3, "rank 3"),
    ("plan_stream_3d", {"m": 8, "grid": (2, 2, 3)}, 4, "12 cells"),
    ("plan_stream_3d", {"m": 17}, 4, "prime factor"),
])
def test_plan_stream_3d_refuses_like_jax(fn, kwargs, rank, match):
    fr = _frames("amr3d", (12, 12, 12))
    fr = fr if rank == 4 else fr[0]
    with pytest.raises(ValueError, match=match):
        getattr(jax_planner, fn)(fr, **kwargs)
    with pytest.raises(ValueError, match=match):
        getattr(planner, fn)(fr, device=CPU, **kwargs)


def test_plan_stream_3d_refuses_mesh_poison_and_int32_overflow():
    fr = _frames("pic3d", (12, 12, 12))
    with pytest.raises(NotImplementedError, match="mesh"):
        planner.plan_stream_3d(fr, m=8, mesh=object(), device=CPU)
    bad = fr.astype(np.float64)
    bad[2, 1, 2, 3] = np.inf
    with pytest.raises(ValueError, match="step\\(s\\) 2"):
        planner.plan_stream_3d(bad, m=8, device=CPU)
    big = np.full((1, 4, 4, 4), 2 ** 26, np.int64)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        planner.plan_stream_3d(big, m=8, gamma_dtype=torch.int32, device=CPU)


# ---------------------------------------------------------------------------
# the NumPy copies


@pytest.mark.parametrize("name", sorted(stream.STREAMS_3D))
def test_streams_3d_match_jax_generators(name):
    np.testing.assert_array_equal(
        _frames(name, (10, 12, 14)),
        jax_stream.STREAMS_3D[name](4, 10, 12, 14, seed=2))


def test_prefix_helpers_match_jax():
    for gen in ("pic_like_instance_3d", "amr_like_instance_3d"):
        a = getattr(prefix, gen)(9, 7, 11, seed=4)
        np.testing.assert_array_equal(
            a, getattr(jax_prefix, gen)(9, 7, 11, seed=4))
        for src in (a, a * 0.25):
            g = prefix.prefix_sum_3d(src)
            want = jax_prefix.prefix_sum_3d(src)
            assert g.dtype == want.dtype
            np.testing.assert_array_equal(g, want)
        box = (1, 8, 0, 5, 3, 11)
        assert prefix.rect_load_3d(g, *box) == jax_prefix.rect_load_3d(g, *box)
        assert prefix.rect_load_3d(g, *box) == \
            a[1:8, 0:5, 3:11].sum() * 0.25


def test_partition3d_matches_jax():
    a = prefix.amr_like_instance_3d(8, 9, 10, seed=1)
    cuts = ([0, 3, 8], [0, 2, 2, 9], [0, 4, 10])
    got = threed.partition3d_from_grid(*cuts, shape=a.shape)
    want = jax_threed.partition3d_from_grid(*cuts, shape=a.shape)
    assert [dataclasses.astuple(b) for b in got.boxes] == \
        [dataclasses.astuple(b) for b in want.boxes]
    assert got.is_valid() and want.is_valid()
    np.testing.assert_array_equal(got.loads(a), want.loads(a))
    assert got.load_imbalance(a) == want.load_imbalance(a)
    overlap = threed.Partition3D(got.boxes + got.boxes[:1], a.shape)
    assert not overlap.is_valid()


def test_plan_to_partition_matches_jax():
    """``Plan.to_partition`` gives the reference's ``Partition`` for plans
    made by either package."""
    from repro.rebalance import batch_device as jax_bd
    fr = stream.refinement_bursts(3, 24, 32, seed=1)
    torch_plans = planner.plan_host(fr, P=3, m=12, device=CPU)
    jax_plans = jax_bd.unstack_plans(
        jax_planner.plan_stream(fr, P=3, m=12), (24, 32))
    for made in (torch_plans, torch_plans_from_jax(
            jax_planner.plan_stream(fr, P=3, m=12), (24, 32))):
        for ours, theirs in zip(made, jax_plans_from_torch(made)):
            got, want = ours.to_partition(), theirs.to_partition()
            assert [dataclasses.astuple(r) for r in got.rects] == \
                [dataclasses.astuple(r) for r in want.rects]
            assert got.shape == want.shape and got.is_valid()
    for ours, theirs in zip(torch_plans, jax_plans):
        assert [dataclasses.astuple(r) for r in ours.to_partition().rects] \
            == [dataclasses.astuple(r) for r in theirs.to_partition().rects]
