"""Replanning policies: when is a new partition worth its migration cost?

The runtime charges ``max_load`` per step (the paper's bottleneck metric —
the step takes as long as its busiest processor) plus, on each replan,
``replan_overhead + alpha * migration_volume``.  A policy sees one
:class:`StepState` per frame and answers "replan now?".

``HysteresisPolicy`` is the interesting one: it estimates the *excess* of
the current plan's bottleneck over what a fresh plan would achieve
(the bottleneck achieved at the last replan, drift-scaled by total load),
and replans only when that excess, amortized over ``horizon`` future
steps, exceeds the predicted migration bill.  The dead-band plus the
excess formulation give hysteresis both ways: a static stream never
triggers (excess is exactly 0), and a transient spike shorter than the
payback horizon is ridden out.

Numpy-only on purpose: the serving batcher and simulator reuse these
policies without touching the card.  The port's copy of
``repro.rebalance.policy``: the same decisions on the same states.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs import trace as _trace

__all__ = ["StepState", "NeverRebalance", "AlwaysRebalance", "EveryK",
           "HysteresisPolicy", "TwoPhaseHysteresis",
           "FaultAwareHysteresis", "replan_mode"]


def replan_mode(policy, state: "StepState") -> str:
    """Grade one replan decision: ``'keep'`` | ``'fast'`` | ``'slow'``.

    The planner-API decision point every graded consumer shares — the 2D
    stream runtime, ``serve.batcher.replan`` and the serve simulator all
    route through here instead of sniffing policy capabilities
    themselves.  Policies exposing ``mode()``
    (:class:`TwoPhaseHysteresis`) grade their effort; a plain
    ``decide()`` policy maps onto fast-or-keep — it adopts the cheap
    candidate whenever it triggers and never escalates.
    """
    if hasattr(policy, "mode"):
        mode = policy.mode(state)
    else:
        mode = "fast" if policy.decide(state) else "keep"
    if _trace.TRACER.enabled:
        _trace.instant("policy.replan_mode", step=state.step, mode=mode,
                       excess=round(state.excess, 3))
    return mode


@dataclasses.dataclass(frozen=True)
class StepState:
    """Everything a policy may condition on at one time-step."""

    step: int                     # frame index (>= 1; step 0 always plans)
    max_load: float               # active plan's bottleneck on this frame
    ideal: float                  # total_load / m (perfect-balance floor)
    total_load: float
    achieved_at_replan: float     # bottleneck right after the last replan
    total_at_replan: float        # total load at the last replan
    steps_since_replan: int
    last_migration_volume: float  # weight moved at the last replan (0 at t=0)
    alpha: float                  # runtime's cost per unit migrated weight
    replan_overhead: float        # runtime's fixed cost per replan
    capacity_changed: bool = False  # a fault event (fail/straggle/recover)
    #                               landed on this step (see rebalance.faults)

    @property
    def expected_fresh(self) -> float:
        """Predicted fresh-plan bottleneck: the last replan's achievement,
        scaled by total-load drift, floored at the perfect balance."""
        scale = self.total_load / max(self.total_at_replan, 1e-30)
        return max(self.achieved_at_replan * scale, self.ideal)

    @property
    def excess(self) -> float:
        """Per-step cost of keeping the stale plan instead of replanning."""
        return self.max_load - self.expected_fresh


class NeverRebalance:
    """Plan once at t=0, ride it forever (the static baseline)."""

    def decide(self, state: StepState) -> bool:
        return False


class AlwaysRebalance:
    """Replan every step (the migration-blind baseline)."""

    def decide(self, state: StepState) -> bool:
        return True


@dataclasses.dataclass
class EveryK:
    """Fixed-period replanning (the knob real simulations hand-tune)."""

    k: int = 10

    def decide(self, state: StepState) -> bool:
        return state.steps_since_replan >= self.k


@dataclasses.dataclass
class HysteresisPolicy:
    """Replan when predicted imbalance x horizon exceeds migration cost.

    horizon: steps over which a fresh plan's gain is assumed to persist.
    band: relative dead-band — excess below ``band * ideal`` never
        triggers, whatever the predicted migration bill.
    """

    horizon: int = 8
    band: float = 0.02

    def decide(self, state: StepState) -> bool:
        if state.excess <= self.band * state.ideal:
            return False
        predicted_cost = (state.replan_overhead
                          + state.alpha * state.last_migration_volume)
        return state.excess * self.horizon > predicted_cost


@dataclasses.dataclass
class TwoPhaseHysteresis(HysteresisPolicy):
    """Phase-aware trigger for two-phase (fast/slow) replanners.

    ``decide`` is inherited unchanged, so this drops into every consumer
    of :class:`HysteresisPolicy`.  Replanners that can grade their effort
    (``dist.cp_balance.replan_contiguous(two_phase=True)``, a HYBRID
    ``hybrid``-vs-``hybrid_fastslow`` replan) call :meth:`mode` instead:
    below the trigger nothing replans (``'keep'``); a moderate excess
    buys only the cheap fast-phase replan (``'fast'``); once the per-step
    excess clears ``slow_band * ideal`` the stale plan is bleeding enough
    to justify the full refinement (``'slow'``) — whose solver the fast
    candidate's bottleneck then warm-seeds.
    """

    slow_band: float = 0.10

    def mode(self, state: StepState) -> str:
        if not self.decide(state):
            return "keep"
        return "slow" if state.excess > self.slow_band * state.ideal \
            else "fast"


@dataclasses.dataclass
class FaultAwareHysteresis(HysteresisPolicy):
    """Hysteresis with fault escalation (``rebalance.faults``).

    Any capacity-change event — failure, straggler, recovery — triggers an
    immediate replan, bypassing the dead-band and payback test: the
    drift-scaled excess estimate extrapolates from a world whose capacity
    no longer exists, so riding it out is never the right call.  (The
    runtime already *forces* a degraded replan on outright failures for
    every policy; this class additionally escalates on stragglers and
    recoveries.)  Ordinary drift keeps the inherited hysteresis trigger.
    """

    def decide(self, state: StepState) -> bool:
        if state.capacity_changed:
            return True
        return super().decide(state)

    def mode(self, state: StepState) -> str:
        if state.capacity_changed:
            return "slow"  # capacity steps are rare: buy the good plan
        return "fast" if self.decide(state) else "keep"
