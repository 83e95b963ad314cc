"""The port's mesh-sharded planner and multi-device migrations
(``repro_torch.dist.ctx``, ``rebalance.planner`` with ``mesh=``,
``rebalance.execute`` with ``devices=``, ``rebalance.runtime`` with
``devices=``), on the CPU.

A mesh here names the CPU more than once (``["cpu"] * D``), the port's
counterpart of the reference's forced host devices.  The reference's own
sharded path fails on this tree (F2 in ``ROADMAP.md``), so the sharded
plans are held against the reference's *single-device* plans
(``batch_device.plan_stream`` and ``plan_stream_3d``), which is the
reference's own contract for its sharded path (``tests/
test_planner_sharded.py``), and against the port's single-device path.
Tolerance: none, on divisible and ragged T alike (cuts, counts, Lmax, and
in 3D iterations and projections).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same, assert_same_plans, ledger_diff,
                           torch_plans_from_jax)
from repro.rebalance import batch_device as jax_bd
from repro.rebalance import migrate as jax_migrate
from repro.rebalance import planner as jax_planner
from repro_torch.dist import ctx
from repro_torch.rebalance import (batch_device, execute, planner, policy,
                                   runtime, stream)

CPU = torch.device("cpu")
P, M = 3, 10
PE, ME = 2, 10   # the exact path needs m % P == 0 (Q = 5)


def _mesh(D: int) -> ctx.Mesh:
    return ctx.planner_mesh(devices=[CPU] * D)


@functools.lru_cache(maxsize=None)
def _reference(T: int, n1: int, n2: int, exact: bool):
    fr = stream.drifting_hotspot(T, n1, n2, seed=5)
    Pj, Mj = (PE, ME) if exact else (P, M)
    return fr, tuple(np.asarray(x) for x in jax_bd.plan_stream(
        jnp.asarray(fr), P=Pj, m=Mj, exact=exact))


# ---------------------------------------------------------------------------
# mesh construction / axis resolution (tests/test_planner_sharded.py:46-70)


def test_planner_mesh_shape_and_axes():
    mesh = ctx.planner_mesh(1, devices=["cpu"])
    assert mesh.axis_names == ("data",)
    assert mesh.shape == {"data": 1} and ctx.mesh_sizes(mesh) == {"data": 1}
    assert ctx.planner_axes(mesh) == ("data",)
    assert ctx.planner_mesh(2, devices=["cpu"] * 5).devices == (CPU, CPU)
    with pytest.raises(ValueError, match="devices requested"):
        ctx.planner_mesh(2, devices=["cpu"])
    assert ctx.axis_entry(()) is None and ctx.axis_entry(("data",)) == "data"
    assert ctx.axis_entry(("pod", "data")) == ("pod", "data")


def test_planner_mesh_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ctx.planner_mesh()


def test_planner_axes_rejects_meshless_dp():
    mesh = ctx.Mesh((CPU, CPU), ("model",))
    assert ctx.dp_axes(mesh) == ()
    with pytest.raises(ValueError, match="no data-parallel axis"):
        ctx.planner_axes(mesh)
    with pytest.raises(ValueError, match="no data-parallel axis"):
        planner.plan_stream(stream.static(2, 8, 8), P=2, m=4, mesh=mesh)


def test_mesh_context_nests():
    a, b = _mesh(1), _mesh(2)
    assert ctx.current_mesh() is None
    with ctx.mesh_context(a):
        with ctx.mesh_context(b):
            assert ctx.current_mesh() is b
        assert ctx.current_mesh() is a
    assert ctx.current_mesh() is None


def test_resolve_mesh():
    assert planner.resolve_mesh(None, None) is None
    assert planner.resolve_mesh(None, 1) is None
    mesh = _mesh(1)
    assert planner.resolve_mesh(mesh, 7) is mesh
    assert planner.resolve_mesh(None, 3, device="cpu") == _mesh(3)
    assert planner.resolve_mesh(None, ["cpu", "cpu"]) == _mesh(2)
    with pytest.raises(TypeError, match="Mesh"):
        planner.resolve_mesh(object())
    with pytest.raises(TypeError, match="one device"):
        planner.resolve_mesh(None, "cpu")
    with pytest.raises(ValueError, match="one axis"):
        ctx.Mesh((CPU,), ("pod", "data"))
    with pytest.raises(ValueError, match="at least one"):
        ctx.Mesh(())


# ---------------------------------------------------------------------------
# sharded == single-device, bit for bit


@pytest.mark.parametrize("D,T", [(1, 6), (1, 7), (2, 8), (2, 7),
                                 (8, 16), (8, 13)])
def test_sharded_matches_single_device(D, T):
    fr, want = _reference(T, 24, 20, False)
    got = planner.plan_stream(fr, P=P, m=M, mesh=_mesh(D))
    assert_same(want, got)
    assert_same(planner.plan_stream(fr, P=P, m=M, device=CPU), got)


@pytest.mark.parametrize("D,T", [(1, 5), (2, 7), (8, 13)])
def test_sharded_exact_matches_single_device(D, T):
    fr, want = _reference(T, 16, 16, True)
    got = planner.plan_stream(fr, P=PE, m=ME, exact=True, mesh=_mesh(D))
    assert_same(want, got)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_sharded_3d_matches_single_device(D):
    """T=5 volumes on 1, 2 and 3 devices (ragged for 2 and 3: the padded
    all-zero volumes converge and are trimmed)."""
    fr = stream.pic_series_3d(5, 12, 10, 14, seed=2)
    want = tuple(np.asarray(x) for x in jax_planner.plan_stream_3d(fr, m=12))
    got = planner.plan_stream_3d(fr, m=12, mesh=_mesh(D))
    assert_same(want, got)
    assert_same(got, planner.plan_stream(fr, P=0, m=12, mesh=_mesh(D)))


def test_sharded_accepts_tensors_and_int32_or_float64_gammas():
    fr = stream.refinement_bursts(5, 20, 24, seed=1)
    for gd, exact, p in ((torch.int32, True, PE), (torch.float64, False, P)):
        want = planner.plan_stream(fr, P=p, m=M, gamma_dtype=gd, exact=exact,
                                   device=CPU)
        assert_same(want, planner.plan_stream(
            torch.from_numpy(fr), P=p, m=M, gamma_dtype=gd, exact=exact,
            mesh=_mesh(2)))


def test_sharded_planner_keeps_the_ingest_guards():
    fr = stream.static(3, 8, 8).astype(np.float64)
    fr[2, 1, 1] = np.nan
    with pytest.raises(ValueError, match="step\\(s\\) 2"):
        planner.plan_stream(fr, P=2, m=4, mesh=_mesh(2))
    big = np.full((3, 4, 4), 2 ** 26, np.int64)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        planner.plan_stream(big, P=2, m=4, exact=True, mesh=_mesh(2))


def test_all_zero_frames_plan_on_every_path():
    """The zero padding's frames, planned on their own: no NaN, no raise,
    and the single-device result."""
    z2 = np.zeros((3, 12, 12), np.int64)
    for exact in (False, True):
        out = planner.plan_stream(z2, P=PE, m=ME, exact=exact, mesh=_mesh(2))
        assert_same(planner.plan_stream(z2, P=PE, m=ME, exact=exact,
                                        device=CPU), out)
        assert not torch.isnan(out[3].double()).any()
    z3 = np.zeros((3, 6, 6, 6), np.int64)
    out = planner.plan_stream_3d(z3, m=8, mesh=_mesh(2))
    assert_same(planner.plan_stream_3d(z3, m=8, device=CPU), out)
    assert (out[3] == 0).all()


# ---------------------------------------------------------------------------
# lazy slices, host plans and stage timing on a mesh


def test_plan_iter_on_mesh_matches_reference():
    fr, want = _reference(7, 24, 20, False)
    ref = torch_plans_from_jax(want, fr.shape[1:])
    for D, size in ((1, 3), (2, 3), (3, None), (8, 1)):
        lazy = list(planner.plan_iter(fr, P=P, m=M, mesh=_mesh(D),
                                      slice_size=size))
        assert_same_plans(lazy, ref)


def test_iter_plan_slices_round_up_to_the_mesh():
    fr = stream.refinement_bursts(11, 20, 16, seed=2)
    spans = [(t0, t1) for t0, t1, _ in planner.iter_plan_slices(
        fr, P=P, m=M, mesh=_mesh(2), slice_size=3)]
    assert spans == [(0, 4), (4, 8), (8, 11)]
    spans = [(t0, t1) for t0, t1, _ in planner.iter_plan_slices(
        fr, P=P, m=M, mesh=_mesh(4))]
    assert spans == [(0, 4), (4, 8), (8, 11)]


def test_plan_host_and_profile_stages_on_mesh():
    fr, want = _reference(6, 24, 20, False)
    ref = torch_plans_from_jax(want, fr.shape[1:])
    assert_same_plans(planner.plan_host(fr, P=P, m=M, mesh=_mesh(4)), ref)
    plans, tim = planner.profile_stages(fr, P=P, m=M, mesh=_mesh(4))
    assert_same_plans(plans, ref)
    assert set(tim) == {"partition", "collect"}


# ---------------------------------------------------------------------------
# the runtime and executed migrations over several devices


@pytest.mark.parametrize("devices", [2, ["cpu"] * 3])
def test_run_stream_and_compare_policies_on_devices(devices):
    fr = stream.drifting_hotspot(10, 24, 24, seed=8)
    kw = dict(P=P, m=M, alpha=0.25, replan_overhead=50.0, device="cpu")
    pols = {"never": policy.NeverRebalance(),
            "hysteresis": policy.HysteresisPolicy(),
            "always": policy.AlwaysRebalance()}
    one = runtime.compare_policies(fr, pols, **kw)
    many = runtime.compare_policies(fr, pols, devices=devices, **kw)
    for name in pols:
        assert ledger_diff(many[name], one[name]) == []
    run = runtime.run_stream(fr, policy.AlwaysRebalance(), devices=devices,
                             execute=True, execute_devices=devices, **kw)
    assert ledger_diff(run, runtime.run_stream(
        fr, policy.AlwaysRebalance(), execute=True, **kw)) == []
    assert all(r.executed_bytes == r.migration_volume
               for r in run.records[1:])
    mesh = planner.resolve_mesh(None, devices, device="cpu")
    assert ledger_diff(runtime.run_stream(fr, policy.HysteresisPolicy(),
                                          mesh=mesh, **kw),
                       one["hysteresis"]) == []


@pytest.mark.parametrize("weighted", [True, False])
def test_execute_migration_on_three_devices(weighted):
    fr = stream.drifting_hotspot(3, 40, 40, seed=2)
    plans = planner.plan_host(fr, P=4, m=12, device=CPU)
    old, new = plans[0], plans[1]
    w = fr[1] if weighted else None
    back = [jax_bd.Plan(p.row_cuts, p.counts, p.col_cuts, p.shape)
            for p in (old, new)]
    one = execute.execute_migration(old, new, w, device=CPU)
    for devices in (["cpu"] * 3, 3):
        r = execute.execute_migration(old, new, w, devices=devices,
                                      device=CPU)
        assert r.executed_bytes == jax_migrate.migration_volume(*back, w)
        np.testing.assert_array_equal(
            r.pair_bytes, jax_migrate.migration_matrix(*back, w))
        np.testing.assert_array_equal(r.device_of, np.arange(12) % 3)
        for f in dataclasses.fields(r):
            if f.name != "device_of":
                np.testing.assert_array_equal(getattr(r, f.name),
                                              getattr(one, f.name))
        execute.verify_receipt(old, new, w, receipt=r)


def test_execute_resolves_devices():
    assert execute.resolve_devices(None, device="cpu") == [CPU]
    assert execute.resolve_devices("cpu") == [CPU]
    assert execute.resolve_devices(2, device="cpu") == [CPU, CPU]
    assert execute.resolve_devices(["cpu"] * 4) == [CPU] * 4
    for bad in (0, []):
        with pytest.raises(ValueError):
            execute.resolve_devices(bad, device="cpu")


def test_batched_plans_are_lane_independent():
    """A frame's plan does not depend on its batch mates: every frame
    planned alone equals its row of the batched call (heuristic, exact and
    3D), which is what makes any sharding bit-identical."""
    fr = stream.pic_series(6, 20, 24, seed=3)
    for exact, (p, m) in ((False, (P, M)), (True, (PE, ME))):
        whole = batch_device.unstack_plans(planner.plan_stream(
            fr, P=p, m=m, exact=exact, device=CPU), fr.shape[1:])
        for t in range(fr.shape[0]):
            alone = planner.plan_host(fr[t:t + 1], P=p, m=m, exact=exact,
                                      device=CPU)
            assert_same_plans(alone, whole[t:t + 1])
    vol = stream.amr_series_3d(4, 10, 12, 8, seed=1)
    whole = planner.plan_stream_3d(vol, m=8, device=CPU)
    for t in range(vol.shape[0]):
        alone = planner.plan_stream_3d(vol[t:t + 1], m=8, device=CPU)
        assert_same(tuple(x[t:t + 1] for x in whole), alone)
