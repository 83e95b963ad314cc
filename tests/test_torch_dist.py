"""Parity of the port's ``repro_torch.dist.{cp_balance,moe_placement}``
with the JAX package's, on the CPU.

Both are NumPy in both packages, so every output is compared bit for bit
(tolerance: none): cut arrays, block -> rank maps, placement rectangles,
imbalances and the ``fell_back`` flag.  The cases are the reference's own:
``tests/test_serve_dist.py``'s MoE and context-parallel tests,
``tests/test_dist_invariants.py``'s cp and moe properties under the same
hypothesis strategies, and ``tests/test_speeds.py::test_consumer_speeds``;
each also checks the property its reference test states, on the port's
output.
"""
import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal containers: fixed-seed shim (tests/_hyp.py)
    from _hyp import given, settings, strategies as st

from repro.dist import cp_balance as jax_cp
from repro.dist import moe_placement as jax_moe
from repro.rebalance import policy as jax_policy
from repro_torch.core import prefix
from repro_torch.dist import cp_balance, moe_placement
from repro_torch.rebalance import policy


def _rects(part) -> list:
    return [dataclasses.astuple(r) for r in part.rects]


def _same_placement(ours, theirs) -> None:
    assert _rects(ours.partition) == _rects(theirs.partition)
    assert ours.partition.shape == theirs.partition.shape
    for f in ("ranks", "algo", "load_imbalance", "uniform_imbalance",
              "fell_back"):
        assert getattr(ours, f) == getattr(theirs, f), f
    np.testing.assert_array_equal(ours.counts, theirs.counts)
    if theirs.speeds is None:
        assert ours.speeds is None
    else:
        np.testing.assert_array_equal(ours.speeds, theirs.speeds)


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# tests/test_serve_dist.py


def test_moe_placement_beats_uniform():
    counts = moe_placement.simulate_router_counts(16, 32, skew=1.2)
    _same(counts, jax_moe.simulate_router_counts(16, 32, skew=1.2))
    plan = moe_placement.plan_expert_placement(counts, 16)
    _same_placement(plan, jax_moe.plan_expert_placement(counts, 16))
    assert plan.partition.is_valid()
    assert plan.load_imbalance < plan.uniform_imbalance


def test_cp_balanced_beats_contiguous():
    nb, R = 64, 8
    for name in ("contiguous_plan", "balanced_plan",
                 "interleaved_assignment"):
        _same(getattr(cp_balance, name)(nb, R), getattr(jax_cp, name)(nb, R))
    naive = cp_balance.plan_imbalance(
        cp_balance.contiguous_plan(nb, R), nb, R)
    bal = cp_balance.plan_imbalance(cp_balance.balanced_plan(nb, R), nb, R)
    zig = cp_balance.plan_imbalance(
        cp_balance.interleaved_assignment(nb, R), nb, R, contiguous=False)
    assert (naive, bal, zig) == (
        jax_cp.plan_imbalance(jax_cp.contiguous_plan(nb, R), nb, R),
        jax_cp.plan_imbalance(jax_cp.balanced_plan(nb, R), nb, R),
        jax_cp.plan_imbalance(jax_cp.interleaved_assignment(nb, R), nb, R,
                              contiguous=False))
    assert naive > 0.5 and bal < naive / 3 and zig <= bal + 1e-9


def test_cp_windowed_costs():
    c = cp_balance.block_costs(10, window_blocks=3)
    _same(c, jax_cp.block_costs(10, window_blocks=3))
    assert list(c[:4]) == [1, 2, 3, 3]


# ---------------------------------------------------------------------------
# tests/test_dist_invariants.py


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(1, 16), st.integers(0, 12))
def test_cp_plans_cover_all_blocks_exactly_once(nb, R, w):
    for ours, theirs in ((cp_balance.contiguous_plan(nb, R),
                          jax_cp.contiguous_plan(nb, R)),
                         (cp_balance.balanced_plan(nb, R, window_blocks=w),
                          jax_cp.balanced_plan(nb, R, window_blocks=w))):
        _same(ours, theirs)
        assert len(ours) == R + 1 and ours[0] == 0 and ours[-1] == nb
        assert (np.diff(ours) >= 0).all()
    owner = cp_balance.interleaved_assignment(nb, R)
    _same(owner, jax_cp.interleaved_assignment(nb, R))
    assert owner.shape == (nb,) and ((owner >= 0) & (owner < R)).all()


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(1, 16), st.integers(0, 12))
def test_cp_balanced_optimal_among_contiguous(nb, R, w):
    bal = cp_balance.balanced_plan(nb, R, window_blocks=w)
    naive = cp_balance.contiguous_plan(nb, R)
    ib = cp_balance.plan_imbalance(bal, nb, R, window_blocks=w)
    inaive = cp_balance.plan_imbalance(naive, nb, R, window_blocks=w)
    assert ib == jax_cp.plan_imbalance(jax_cp.balanced_plan(
        nb, R, window_blocks=w), nb, R, window_blocks=w)
    assert inaive == jax_cp.plan_imbalance(naive, nb, R, window_blocks=w)
    assert ib <= inaive + 1e-9
    c = cp_balance.block_costs(nb, w)
    p = np.concatenate([[0], np.cumsum(c)])
    lmax = float((p[bal[1:]] - p[bal[:-1]]).max(initial=0))
    assert lmax >= max(float(c.sum()) / R, float(c.max(initial=0))) - 1e-9


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(1, 16), st.integers(0, 12))
def test_cp_two_phase_valid_and_between_bounds(nb, R, w):
    R = min(R, nb)
    tp = cp_balance.balanced_plan_two_phase(nb, R, window_blocks=w)
    _same(tp, jax_cp.balanced_plan_two_phase(nb, R, window_blocks=w))
    assert len(tp) == R + 1 and tp[0] == 0 and tp[-1] == nb
    assert (np.diff(tp) >= 0).all()
    i_tp = cp_balance.plan_imbalance(tp, nb, R, window_blocks=w)
    i_opt = cp_balance.plan_imbalance(
        cp_balance.balanced_plan(nb, R, window_blocks=w), nb, R,
        window_blocks=w)
    i_naive = cp_balance.plan_imbalance(
        cp_balance.contiguous_plan(nb, R), nb, R, window_blocks=w)
    assert i_opt - 1e-12 <= i_tp <= i_naive + 1e-9


@pytest.mark.parametrize("n_blocks,kw", [
    (64, {}), (96, {}), (96, {"slow_band": 1e9}), (80, {"slow_band": 0.0})])
@pytest.mark.parametrize("two_phase", [True, False])
def test_cp_phase_aware_replan_modes(n_blocks, kw, two_phase):
    """``replan_contiguous`` grades as the reference's: a static context
    keeps, a grown one adopts the fast two-phase split or escalates to the
    exact split warm-seeded at the two-phase bottleneck."""
    cuts = cp_balance.balanced_plan(64, 8)
    ours = cp_balance.replan_contiguous(
        cuts, n_blocks, two_phase=two_phase,
        policy=policy.TwoPhaseHysteresis(**kw))
    theirs = jax_cp.replan_contiguous(
        cuts, n_blocks, two_phase=two_phase,
        policy=jax_policy.TwoPhaseHysteresis(**kw))
    _same(ours[0], theirs[0])
    assert ours[1] == theirs[1]
    if n_blocks == 64:
        assert not ours[1] and (ours[0] == cuts).all()
    elif two_phase and kw.get("slow_band") == 1e9:
        _same(ours[0], cp_balance.balanced_plan_two_phase(n_blocks, 8))
    elif n_blocks == 96 and not kw:
        _same(ours[0], cp_balance.balanced_plan(n_blocks, 8))


@pytest.mark.parametrize("alpha,steps", [(0.0, 1), (1e6, 1), (0.5, 40)])
def test_cp_replan_under_hysteresis_and_speeds(alpha, steps):
    """The plain hysteresis trigger, the migration bill and a straggler's
    speeds give the reference's cuts and decision."""
    cuts = cp_balance.balanced_plan(48, 6)
    sp = np.array([1.0, 1.0, 0.4, 1.0, 1.0, 0.0])
    for speeds in (None, sp):
        kw = dict(alpha=alpha, steps_since_replan=steps,
                  last_migration_volume=12.0, speeds=speeds)
        ours = cp_balance.replan_contiguous(cuts, 60, **kw)
        theirs = jax_cp.replan_contiguous(cuts, 60, **kw)
        _same(ours[0], theirs[0])
        assert ours[1] == theirs[1]


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 24), st.integers(2, 24), st.integers(2, 20),
       st.integers(0, 10**6))
def test_moe_plans_valid_and_never_worse_than_uniform(L, E, ranks, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 500, (L, E)).astype(np.int64)
    plan = moe_placement.plan_expert_placement(counts, ranks)
    _same_placement(plan, jax_moe.plan_expert_placement(counts, ranks))
    assert plan.partition.is_valid()
    assert plan.partition.shape == (L, E)
    assert plan.load_imbalance <= plan.uniform_imbalance + 1e-9
    loads = [counts[r.r0:r.r1, r.c0:r.c1].sum() for r in plan.partition.rects]
    avg = counts.sum() / ranks
    assert plan.load_imbalance == (max(loads) / avg - 1.0 if avg else 0.0)


@pytest.mark.parametrize("algo", ["jag-m-heur-probe", "jag-pq-heur",
                                  "rect-uniform", "hier-relaxed", "hybrid"])
def test_moe_placement_by_algo_matches_jax(algo):
    counts = moe_placement.simulate_router_counts(12, 16, skew=1.1, seed=3)
    _same_placement(moe_placement.plan_expert_placement(counts, 16, algo),
                    jax_moe.plan_expert_placement(counts, 16, algo))


# ---------------------------------------------------------------------------
# tests/test_speeds.py::test_consumer_speeds


def test_consumer_speeds():
    R = 8
    base = cp_balance.balanced_plan(64, R)
    _same(base, cp_balance.balanced_plan(64, R, speeds=np.ones(R)))
    sp = np.array([1, 1, 0, 1, 0.5, 1, 1, 1], dtype=np.float64)
    cuts = cp_balance.balanced_plan(64, R, speeds=sp)
    _same(cuts, jax_cp.balanced_plan(64, R, speeds=sp))
    _same(cp_balance.balanced_plan_two_phase(64, R, speeds=sp),
          jax_cp.balanced_plan_two_phase(64, R, speeds=sp))
    p = np.concatenate([[0], np.cumsum(cp_balance.block_costs(64))])
    assert (p[cuts[3]] - p[cuts[2]]) == 0
    imb = cp_balance.plan_imbalance(cuts, 64, R, speeds=sp)
    assert imb == jax_cp.plan_imbalance(cuts, 64, R, speeds=sp)
    assert np.isfinite(imb)

    counts = moe_placement.simulate_router_counts(16, 32, skew=1.2)
    spm = np.ones(16)
    spm[5] = 0.0
    plan = moe_placement.plan_expert_placement(counts, 16, speeds=spm)
    _same_placement(plan, jax_moe.plan_expert_placement(counts, 16,
                                                         speeds=spm))
    gm = prefix.prefix_sum_2d(counts)
    assert float(np.asarray(plan.partition.loads(gm))[5]) == 0.0
    assert not plan.fell_back
    assert np.isinf(plan.uniform_imbalance)
    assert np.isfinite(plan.load_imbalance)
