"""The rebalance runtime (``repro_torch.rebalance.{policy,faults,runtime}``)
against the JAX package's, on the CPU.

Inputs are the ``STREAMS`` generators at the size of the reference's
fault bench (T=16 frames of 48x48, P=4, m=16), made from a seed with
NumPy and handed to both packages.  Tolerance: none.  A ledger is every
``StepRecord`` field but ``wall_time`` (a host clock) and the final
plan's arrays; fault schedules are compared event for event and
capacity plans array for array.
"""
import dataclasses
import functools
import itertools
import json

import numpy as np
import pytest
import torch

from _torch_parity import (assert_same_plans, jax_tracer_kept,  # noqa: F401
                           ledger_diff)
from repro.obs import trace as jax_trace
from repro.rebalance import faults as jax_faults
from repro.rebalance import planner as jax_planner
from repro.rebalance import policy as jax_policy
from repro.rebalance import runtime as jax_runtime
from repro.rebalance import stream as jax_stream
from repro_torch import obs
from repro_torch.core import prefix
from repro_torch.rebalance import faults, planner, policy, runtime

T, N, P, M = 16, 48, 4, 16
STREAMS = ("drifting_hotspot", "pic_series", "refinement_bursts")
KW = dict(P=P, m=M, alpha=0.25, replan_overhead=1000.0, validate=True)


def _policies(mod) -> dict:
    return {"never": mod.NeverRebalance(), "always": mod.AlwaysRebalance(),
            "every4": mod.EveryK(4), "hysteresis": mod.HysteresisPolicy(),
            "two-phase": mod.TwoPhaseHysteresis(),
            "fault-aware": mod.FaultAwareHysteresis()}


@functools.lru_cache(maxsize=None)
def _frames(name: str) -> np.ndarray:
    return getattr(jax_stream, name)(T, N, N, seed=0)


def _hand_schedule(mod):
    """``benchmarks/bench_faults.py``'s schedule at T=16: two failures,
    one straggler, one recovery."""
    return mod.FaultSchedule(M, [
        mod.FaultEvent(T // 3, 3, "fail"),
        mod.FaultEvent(T // 2, 11, "fail"),
        mod.FaultEvent(T // 2, 7, "straggle", speed=0.3),
        mod.FaultEvent(2 * T // 3, 3, "recover"),
    ])


def _schedule(mod, scenario):
    if scenario is None:
        return None
    if scenario == "hand":
        return _hand_schedule(mod)
    return mod.FAULT_SCENARIOS[scenario](T, M, seed=0)


# ---------------------------------------------------------------------------
# policies


def _states(mod) -> list:
    grid = itertools.product(
        [0.0, 90.0, 100.0, 104.0, 125.0, 400.0],   # max_load
        [100.0],                                    # ideal
        [1600.0, 2400.0],                           # total_load
        [95.0, 100.0, 130.0],                       # achieved_at_replan
        [1600.0, 3200.0],                           # total_at_replan
        [0, 1, 4, 10],                              # steps_since_replan
        [0.0, 500.0],                               # last_migration_volume
        [0.0, 1.0], [0.0, 50.0],                    # alpha, overhead
        [False, True])                              # capacity_changed
    return [mod.StepState(5, *s[:5], s[5], *s[6:]) for s in grid]


@pytest.mark.parametrize("name", list(_policies(policy)))
def test_policies_decide_as_the_reference(name):
    """``decide``, ``mode`` (where the policy has one) and
    ``replan_mode`` on a grid of 4,608 step states."""
    ours, theirs = _policies(policy)[name], _policies(jax_policy)[name]
    for s_t, s_j in zip(_states(policy), _states(jax_policy)):
        assert (s_t.expected_fresh, s_t.excess) == \
            (s_j.expected_fresh, s_j.excess)
        assert ours.decide(s_t) == theirs.decide(s_j)
        assert hasattr(ours, "mode") == hasattr(theirs, "mode")
        if hasattr(ours, "mode"):
            assert ours.mode(s_t) == theirs.mode(s_j)
        assert policy.replan_mode(ours, s_t) == \
            jax_policy.replan_mode(theirs, s_j)
    assert planner.replan_mode is policy.replan_mode


@pytest.mark.usefixtures("jax_tracer_kept")
def test_replan_mode_traces_its_decision():
    state = _states(policy)[200]
    with obs.tracing() as tr:
        mode = planner.replan_mode(policy.TwoPhaseHysteresis(), state)
    with jax_trace.tracing() as jtr:
        jax_policy.replan_mode(jax_policy.TwoPhaseHysteresis(),
                               _states(jax_policy)[200])
    ev = [e for e in tr.events() if e["name"] == "policy.replan_mode"]
    jev = [e for e in jtr.events() if e["name"] == "policy.replan_mode"]
    assert len(ev) == 1 and ev[0]["args"] == jev[0]["args"]
    assert ev[0]["args"]["mode"] == mode


# ---------------------------------------------------------------------------
# fault schedules


@pytest.mark.parametrize("events,match", [
    ([(1, 2, "melt", 1.0)], "kind must be"),
    ([(1, 2, "straggle", 0.0)], "needs speed > 0"),
    ([(1, 2, "recover", -1.0)], "needs speed > 0"),
    ([(1, 4, "fail", 1.0)], "out of range"),
    ([(-1, 0, "fail", 1.0)], "< 0"),
    ([(1, p, "fail", 1.0) for p in range(4)], "all 4 parts dead"),
])
def test_fault_schedule_validation(events, match):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match=match):
            mod.FaultSchedule(4, [mod.FaultEvent(*e) for e in events])


def _events(sched) -> list:
    return [dataclasses.astuple(e) for e in sched.events]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scenario,kw", [
    ("random-failures", {}),
    ("random-failures", dict(n_failures=3, n_straggles=2, n_recoveries=2,
                             straggle_speed=0.5)),
    ("rack-failure", {}),
    ("rack-failure", dict(rack_size=3, fail_at=4, recover_at=11)),
])
def test_fault_scenarios_are_the_reference_s(seed, scenario, kw):
    ours = faults.FAULT_SCENARIOS[scenario](T, M, seed=seed, **kw)
    theirs = jax_faults.FAULT_SCENARIOS[scenario](T, M, seed=seed, **kw)
    assert ours.m == theirs.m and _events(ours) == _events(theirs)
    for t in range(T):
        np.testing.assert_array_equal(ours.speeds_at(t), theirs.speeds_at(t))
        np.testing.assert_array_equal(ours.failed_at(t), theirs.failed_at(t))
        assert [dataclasses.astuple(e) for e in ours.events_at(t)] == \
            [dataclasses.astuple(e) for e in theirs.events_at(t)]


def test_fault_scenarios_refuse_an_empty_cluster():
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match="n_failures"):
            mod.random_failures(T, 3, n_failures=2, n_straggles=1)
        with pytest.raises(ValueError, match="rack_size"):
            mod.rack_failure(T, 2, rack_size=2)


def _speeds(kind: str):
    if kind == "homogeneous":
        return None
    sp = np.ones(M)
    if kind == "uniform":
        return sp * 2.0
    sp[[3, 11]] = 0.0
    sp[7] = 0.3
    sp[[1, 2]] = [2.5, 1.7]
    return sp


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("speeds", ["homogeneous", "uniform", "degraded"])
@pytest.mark.parametrize("optimal", [True, False])
def test_capacity_plan_matches_jax(name, speeds, optimal):
    """Homogeneous, all-equal and heterogeneous speeds (two dead parts, a
    straggler, two fast ones) on three frames of each stream; the dead
    parts' rectangles are empty."""
    sp = _speeds(speeds)
    for t in (0, 7, 15):
        f = _frames(name)[t]
        g = prefix.prefix_sum_2d(f)
        ours = faults.capacity_plan(g, P=P, m=M, speeds=sp, optimal=optimal)
        theirs = jax_faults.capacity_plan(g, P=P, m=M, speeds=sp,
                                          optimal=optimal)
        assert_same_plans([ours], [theirs])
        assert_same_plans([faults.frame_capacity_plan(
            f, P=P, m=M, speeds=sp, optimal=optimal)], [ours])
        ours.validate(g, m=M)
        if speeds == "degraded":
            owners = np.unique(ours.owner_map())
            assert not np.isin([3, 11], owners).any()


# ---------------------------------------------------------------------------
# the runtime


@pytest.mark.parametrize("scenario", [None, "random-failures",
                                      "rack-failure", "hand"])
@pytest.mark.parametrize("name", STREAMS)
def test_compare_policies_ledgers_match_jax(name, scenario):
    """Every policy over the same planner stream, with and without
    faults: the ledgers are the reference's."""
    fr = _frames(name)
    ours = runtime.compare_policies(fr, _policies(policy),
                                    faults=_schedule(faults, scenario),
                                    device="cpu", **KW)
    theirs = jax_runtime.compare_policies(
        fr, _policies(jax_policy), faults=_schedule(jax_faults, scenario),
        **KW)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ledger_diff(ours[k], theirs[k]) == [], k
        assert ours[k].summary() == theirs[k].summary()
    if scenario is not None:
        sched = _schedule(faults, scenario)
        fails = {e.step for e in sched.events if e.kind == "fail"}
        for res in ours.values():
            forced = {r.step for r in res.records if r.forced}
            assert forced == fails
            assert all(np.isfinite(r.max_load) for r in res.records)


@pytest.mark.parametrize("name", STREAMS)
def test_run_stream_matches_jax(name):
    """``run_stream`` planning lazily through ``plan_iter`` (no ``plans``
    or ``gammas`` given), with weight "load" and "cells", under the hand
    schedule."""
    fr = _frames(name)
    for weight in ("load", "cells"):
        kw = dict(KW, weight=weight)
        ours = runtime.run_stream(fr, policy.FaultAwareHysteresis(),
                                  faults=_hand_schedule(faults),
                                  device="cpu", **kw)
        theirs = jax_runtime.run_stream(fr, jax_policy.FaultAwareHysteresis(),
                                        faults=_hand_schedule(jax_faults),
                                        **kw)
        assert ledger_diff(ours, theirs) == []
        assert ours.n_forced == theirs.n_forced == 2
        assert ours.evacuation_volume == theirs.evacuation_volume > 0


def test_run_stream_executes_migrations_as_priced():
    """``execute=True``: every replan's migration is executed on the CPU,
    its measured bytes equal the priced volume and the reference's."""
    fr = _frames("refinement_bursts")
    ours = runtime.run_stream(fr, policy.FaultAwareHysteresis(),
                              faults=_hand_schedule(faults), execute=True,
                              device="cpu", **KW)
    theirs = jax_runtime.run_stream(fr, jax_policy.FaultAwareHysteresis(),
                                    faults=_hand_schedule(jax_faults),
                                    execute=True, **KW)
    assert ledger_diff(ours, theirs) == []
    replans = [r for r in ours.records[1:] if r.replanned]
    assert replans and all(r.executed_bytes == r.migration_volume
                           for r in replans)
    assert all(r.executed_bytes is None for r in ours.records
               if not r.replanned or r.step == 0)


def test_plan_stream_host_matches_jax():
    """One planner call per stream; in float64 too, which equals float32
    here (the frames' totals stay below 2**24)."""
    fr = _frames("pic_series")
    assert_same_plans(runtime.plan_stream_host(fr, P=P, m=M, device="cpu"),
                      jax_runtime.plan_stream_host(fr, P=P, m=M))
    assert_same_plans(
        runtime.plan_stream_host(fr, P=P, m=M, gamma_dtype=torch.float64,
                                 device="cpu"),
        jax_planner.plan_host(fr, P=P, m=M))


def test_run_stream_on_given_plans_and_float64():
    """Plans handed in (a list or a generator) give the same ledger as the
    lazy planner; ``gamma_dtype=float64`` plans exactly (the frames'
    totals stay below 2**24 here, so it equals float32)."""
    fr = _frames("drifting_hotspot")
    pol = policy.HysteresisPolicy()
    base = runtime.run_stream(fr, pol, device="cpu", **KW)
    plans = planner.plan_host(fr, P=P, m=M, device="cpu")
    gammas = [prefix.prefix_sum_2d(f) for f in fr]
    for given in (plans, iter(plans)):
        assert ledger_diff(runtime.run_stream(
            fr, pol, plans=given, gammas=gammas, device="cpu", **KW),
            base) == []
    assert ledger_diff(runtime.run_stream(
        fr, pol, gamma_dtype=torch.float64, device="cpu", **KW), base) == []


def test_run_stream_refuses_what_is_not_ported_or_malformed():
    fr = _frames("drifting_hotspot")
    pol = policy.NeverRebalance()
    with pytest.raises(ValueError, match="weight"):
        runtime.run_stream(fr, pol, P=P, m=M, weight="bytes", device="cpu")
    with pytest.raises(ValueError, match="plans ran out at step 3"):
        runtime.run_stream(fr, pol, P=P, m=M, device="cpu",
                           plans=planner.plan_host(fr[:3], P=P, m=M,
                                                   device="cpu"))
    with pytest.raises(ValueError, match="m=8"):
        runtime.run_stream(fr, pol, P=P, m=M, device="cpu",
                           faults=faults.rack_failure(T, 8))
    # named for the refusals it held before the sharded planner and the
    # multi-device migrations were ported: a malformed mesh still raises,
    # devices=2 (two entries of the CPU) now plans the single-device
    # ledger, and migrations execute across several devices
    with pytest.raises(TypeError, match="mesh"):
        runtime.run_stream(fr, pol, P=P, m=M, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        runtime.compare_policies(fr, {"n": pol}, P=P, m=M, device="cpu",
                                 mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        runtime.plan_stream_host(fr, P=P, m=M, device="cpu", mesh=object())
    assert ledger_diff(runtime.run_stream(fr, pol, P=P, m=M, device="cpu",
                                          devices=2),
                       runtime.run_stream(fr, pol, P=P, m=M,
                                          device="cpu")) == []
    assert_same_plans(runtime.plan_stream_host(fr, P=P, m=M, device="cpu",
                                               devices=2),
                      runtime.plan_stream_host(fr, P=P, m=M, device="cpu"))
    two = runtime.run_stream(fr, policy.AlwaysRebalance(), P=P, m=M,
                             execute=True, execute_devices=["cpu", "cpu"],
                             device="cpu")
    assert all(r.executed_bytes == r.migration_volume
               for r in two.records[1:])
    one = runtime.run_stream(fr[:3], policy.AlwaysRebalance(), P=P, m=M,
                             execute=True, execute_devices=["cpu"],
                             devices=1, device="cpu")
    assert one.records[1].executed_bytes == one.records[1].migration_volume


def test_trace_events_are_a_valid_chrome_trace(tmp_path):
    fr = _frames("refinement_bursts")
    with obs.tracing() as tr:
        res = runtime.run_stream(fr, policy.FaultAwareHysteresis(),
                                 faults=_hand_schedule(faults),
                                 device="cpu", **KW)
    ev = res.trace_events(scale=1e-3)
    doc = obs.chrome_trace(ev)
    obs.validate_chrome_trace(doc)
    path = tmp_path / "run.json"
    obs.write_chrome_trace(str(path), ev)
    obs.validate_chrome_trace(json.loads(path.read_text()))
    replans = [e for e in ev if e["name"] == "replan"]
    assert len(replans) == sum(r.replanned for r in res.records)
    assert sum(e["args"].get("forced", False) for e in replans) == 2
    steps = [e for e in tr.events() if e["name"] == "runtime.step"]
    assert len(steps) == T
