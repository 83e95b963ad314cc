"""Parity of the port's frame planner (``repro_torch.rebalance.planner``
and ``batch_device``) with the JAX package's, end to end on the CPU.

Both packages get the same ``STREAMS`` frames (T=3, 48x64, P=4, m=16,
made from a seed with NumPy).  The JAX planner runs with its Pallas
kernels in interpret mode and on its plain versions.  Tolerance: none
where frame totals stay below 2**24, where the float32 heuristic is
bit-identical too; above 2**24 only
``test_plan_stream_above_2_24_matches_jax`` runs, and its docstring
states its tolerance on Lmax.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_parity import (assert_same, assert_same_plans, jax_plans_from_torch,
                           torch_plans_from_jax)
from repro.rebalance import batch_device as jax_bd
from repro.rebalance import planner as jax_planner
from repro.rebalance import stream as jax_stream
from repro_torch import obs
from repro_torch.core import prefix
from repro_torch.rebalance import batch_device, planner, stream

T, N1, N2, P, M = 3, 48, 64, 4, 16
CPU = "cpu"
STREAMS = sorted(stream.STREAMS)


@functools.lru_cache(maxsize=None)
def _frames(name: str) -> np.ndarray:
    return stream.STREAMS[name](T, N1, N2, seed=5)


@functools.lru_cache(maxsize=None)
def _jax_plan(name: str, exact: bool, use_pallas: bool):
    out = jax_planner.plan_stream(_frames(name), P=P, m=M, exact=exact,
                                  use_pallas=use_pallas, interpret=True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("name", STREAMS)
def test_streams_match_jax_generators(name):
    np.testing.assert_array_equal(
        _frames(name), jax_stream.STREAMS[name](T, N1, N2, seed=5))


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("exact", [False, True])
def test_plan_stream_matches_jax(name, exact):
    got = planner.plan_stream(_frames(name), P=P, m=M, exact=exact,
                              device=CPU)
    for use_pallas in (True, False):
        assert_same(_jax_plan(name, exact, use_pallas), got)
    assert_same(got, batch_device.plan_stream(_frames(name), P=P, m=M,
                                              exact=exact, device=CPU))


@pytest.mark.parametrize("n1,n2", [(16, 16), (5, 40)])
@pytest.mark.parametrize("kind", ["pic", "uniform"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_stream_above_2_24_matches_jax(n1, n2, kind, seed):
    """The float32 heuristic with frame totals above 2**24 (1.0e8 to
    2.1e8): the paper's PIC frames scaled so the largest cell is 2**20,
    and integer loads drawn uniformly from [0, 2**20).

    Cuts and counts are equal.  Lmax is held to a relative 4e-6: above
    2**24 the bisection's float32 candidates are rounded at the frame
    total's scale (an ulp of 8 at 1e8), and the two packages take the
    final bisection's sums in another order, so Lmax may differ by a few
    ulps of the total.  Measured at up to 2.0e-6 (32 = 4 ulps of a 1.1e8
    total), as far as the JAX package's own Pallas and plain routes
    differ from each other on these frames (also 2.0e-6).
    """
    if kind == "pic":
        fr = stream.pic_series(4, n1, n2, seed=seed)
        fr = fr * (2 ** 20 // int(fr.max()))
    else:
        fr = np.random.default_rng(seed).integers(0, 2 ** 20, (4, n1, n2))
    assert fr.sum(axis=(1, 2)).min() > 2 ** 24 and fr.max() <= 2 ** 20
    got = [x.numpy() for x in planner.plan_stream(fr, P=P, m=M, device=CPU)]
    assert got[3].dtype == np.float32
    for use_pallas in (True, False):
        want = [np.asarray(x) for x in jax_planner.plan_stream(
            fr, P=P, m=M, use_pallas=use_pallas, interpret=True)]
        for a, b in zip(got[:3], want[:3]):   # row cuts, counts, col cuts
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want[3], rtol=4e-6, atol=0)


@pytest.mark.parametrize("exact", [False, True])
def test_plan_host_iter_and_profile_give_the_same_valid_plans(exact):
    fr = _frames("drifting-hotspot")
    plans = planner.plan_host(fr, P=P, m=M, exact=exact, device=CPU)
    want = torch_plans_from_jax(_jax_plan("drifting-hotspot", exact, True),
                                (N1, N2))
    assert_same_plans(plans, want)
    for t, pl in enumerate(plans):
        pl.validate(prefix.prefix_sum_2d(fr[t]), m=M)
    assert_same_plans(planner.plan_host(fr, P=P, m=M, exact=exact,
                                        device=torch.device(CPU)), plans)
    for size in (1, 2, None):
        assert_same_plans(list(planner.plan_iter(
            fr, P=P, m=M, exact=exact, slice_size=size, device=CPU)), plans)
    prof, timings = planner.profile_stages(fr, P=P, m=M, exact=exact,
                                           device=CPU)
    assert_same_plans(prof, plans)
    assert set(timings) == {"ingest", "sat", "partition", "collect"}
    assert all(v >= 0 for v in timings.values())


def test_plans_validate_across_packages():
    """A plan made by one package is a valid plan of the other, with the
    same per-rectangle loads."""
    fr = _frames("particle-advection")
    jax_plans = jax_planner.plan_host(fr, P=P, m=M)
    ours = planner.plan_host(fr, P=P, m=M, device=CPU)
    for t, (a, b) in enumerate(zip(torch_plans_from_jax(
            _jax_plan("particle-advection", False, True), (N1, N2)), ours)):
        g = prefix.prefix_sum_2d(fr[t])
        a.validate(g, m=M)
        np.testing.assert_array_equal(a.loads(g), jax_plans[t].loads(g))
        np.testing.assert_array_equal(a.owner_map(), jax_plans[t].owner_map())
    for jp in jax_plans_from_torch(ours):
        jp.validate(m=M)
    assert_same_plans(jax_plans_from_torch(ours), jax_plans)


def test_gamma_batch_and_jag_m_heur_batch_match_jax():
    fr = _frames("refinement-bursts")
    gj = jax_bd.gamma_batch(fr)
    g = batch_device.gamma_batch(fr, device=CPU)
    assert_same(gj, g)
    assert_same(jax_bd.jag_m_heur_batch(gj, P=P, m=M),
                batch_device.jag_m_heur_batch(g, P=P, m=M, device=CPU))


def test_plan_validate_reports_problems():
    pl = planner.plan_host(_frames("static"), P=P, m=M, device=CPU)[0]
    g = prefix.prefix_sum_2d(_frames("static")[0])
    with pytest.raises(ValueError, match="rectangles"):
        pl.validate(g, m=M + 1)
    bad = batch_device.Plan(pl.row_cuts[::-1].copy(), pl.counts, pl.col_cuts,
                            pl.shape)
    with pytest.raises(ValueError, match="row cuts"):
        bad.validate()


@pytest.mark.parametrize("kwargs,exc", [
    ({"mesh": object()}, NotImplementedError),
    ({"exact": True, "m": 15}, ValueError),
])
def test_plan_stream_refuses(kwargs, exc):
    args = {"P": P, "m": M, "device": CPU}
    args.update(kwargs)
    with pytest.raises(exc):
        planner.plan_stream(_frames("static"), **args)


def test_rank3_frames_are_not_ported_yet():
    """Rank-3 frames plan through ``plan_stream`` on one device (see
    ``test_torch_planner3d.py``); their mesh-sharded planner is not ported
    yet, and the 2D-only entry points refuse them."""
    vol = np.ones((2, 4, 4, 4))
    assert len(planner.plan_stream(vol, P=2, m=4, device=CPU)) == 6
    with pytest.raises(NotImplementedError):
        planner.plan_stream(vol, P=2, m=4, mesh=object(), device=CPU)
    for call in (planner.plan_host, planner.profile_stages,
                 lambda *a, **k: list(planner.plan_iter(*a, **k))):
        with pytest.raises(ValueError, match="plan_stream_3d"):
            call(vol, P=2, m=4, device=CPU)


def test_poisoned_frames_are_named():
    fr = _frames("static").astype(np.float64)
    fr[2, 3, 4] = np.nan
    with pytest.raises(ValueError, match="step\\(s\\) 2"):
        planner.plan_stream(fr, P=P, m=M, device=CPU)
    with pytest.raises(ValueError, match="step\\(s\\) 2"):
        planner.plan_stream(torch.from_numpy(fr), P=P, m=M, device=CPU)
    with pytest.raises(ValueError, match="planner slice 1"):
        list(planner.plan_iter(fr, P=P, m=M, slice_size=2, device=CPU))


def test_exact_planning_refuses_totals_above_2_30():
    fr = np.full((1, 4, 4), 2 ** 26, dtype=np.int64)
    with pytest.raises(ValueError, match="2\\*\\*30"):
        planner.plan_stream(fr, P=2, m=4, exact=True, device=CPU)


def test_planner_spans_reach_the_tracer():
    """The planner's spans land in the tracer (and, with the bridge on,
    in a ``torch.profiler`` trace); the export is valid Chrome JSON."""
    from torch.profiler import ProfilerActivity, profile
    fr = _frames("static")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.tracing(torch_annotations=True) as tracer:
            list(planner.plan_iter(fr, P=P, m=M, slice_size=2, device=CPU))
            planner.profile_stages(fr, P=P, m=M, device=CPU)
    names = {ev["name"] for ev in obs.validate_chrome_trace(
        tracer.chrome_trace())}
    want = {"planner.dispatch", "planner.collect", "planner.stage.ingest",
            "planner.stage.sat", "planner.stage.partition",
            "planner.stage.collect"}
    assert want <= names
    assert want <= {e.key for e in prof.key_averages()}
    assert not obs.enabled()
    with pytest.raises(ValueError, match="bad ph"):
        obs.validate_chrome_trace([{"name": "x", "ph": "?", "pid": 0,
                                    "tid": 0, "ts": 0}])
