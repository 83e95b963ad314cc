"""Fault injection for the time-stepped rebalancing runtime.

A :class:`FaultSchedule` is a list of capacity events over the T-step
stream: a processor *fails* (speed drops to 0 — it can hold no
rectangles), *straggles* (speed shrinks — it should hold proportionally
less load), or *recovers* (speed restored).  ``runtime.run_stream``
consumes the schedule: a failure forces an immediate degraded replan over
the surviving capacity (policy escalation — hysteresis is bypassed,
because the active plan still assigns rectangles to a dead part), a
straggler only flips ``StepState.capacity_changed`` and lets the policy's
``replan_mode`` grade keep/fast/slow as usual, and the cost ledger
additionally charges the *evacuation volume* — the weight leaving the
failed parts' rectangles, read off ``migrate.migration_matrix``.

The capacity-aware candidate plans come from :func:`capacity_plan`, a
host-side planner on the heterogeneous engine (``core.oned`` /
``core.jagged`` with ``speeds=``): dead positions get zero-width
rectangles, stragglers get narrow ones, and the homogeneous
(``speeds=None`` / all-equal) path is bit-identical to the device
planner's stripe shape contract so plan diffs stay meaningful.

The port's NumPy copy of ``repro.rebalance.faults``, over the port's host
engine: the same seed gives the same schedule, and the same Gamma the
same plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import jagged, oned, prefix, search

from . import batch_device

__all__ = ["FaultEvent", "FaultSchedule", "random_failures", "rack_failure",
           "FAULT_SCENARIOS", "capacity_plan", "frame_capacity_plan"]

_KINDS = ("fail", "straggle", "recover")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One capacity change landing at the start of step ``step``."""

    step: int
    part: int
    kind: str               # "fail" | "straggle" | "recover"
    speed: float = 1.0      # new speed for "straggle"/"recover"; ignored
    #                         for "fail" (always 0)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind != "fail" and not self.speed > 0:
            raise ValueError(f"{self.kind!r} needs speed > 0, "
                             f"got {self.speed}")

    @property
    def new_speed(self) -> float:
        return 0.0 if self.kind == "fail" else float(self.speed)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Capacity events for an ``m``-processor run; all parts start at 1.0.

    Validated on construction: every event targets a real part, and at
    least one processor stays alive after every prefix of events (an
    all-dead cluster has no feasible plan).
    """

    m: int
    events: tuple[FaultEvent, ...]

    def __init__(self, m: int, events):
        object.__setattr__(self, "m", int(m))
        evs = tuple(sorted(events, key=lambda e: (e.step, e.part)))
        object.__setattr__(self, "events", evs)
        speeds = np.ones(self.m)
        for e in evs:
            if not (0 <= e.part < self.m):
                raise ValueError(f"event part {e.part} out of range "
                                 f"[0, {self.m})")
            if e.step < 0:
                raise ValueError(f"event step {e.step} < 0")
            speeds[e.part] = e.new_speed
            if not (speeds > 0).any():
                raise ValueError(f"all {self.m} parts dead after step "
                                 f"{e.step}: no capacity left to plan on")

    def events_at(self, t: int) -> list[FaultEvent]:
        """Events landing exactly at step ``t``."""
        return [e for e in self.events if e.step == t]

    def speeds_at(self, t: int) -> np.ndarray:
        """(m,) speed vector in effect *at* step ``t`` (events <= t)."""
        speeds = np.ones(self.m)
        for e in self.events:
            if e.step <= t:
                speeds[e.part] = e.new_speed
        return speeds

    def failed_at(self, t: int) -> np.ndarray:
        """Indices of dead (speed 0) parts at step ``t``."""
        return np.flatnonzero(self.speeds_at(t) == 0.0)


# ---------------------------------------------------------------------------
# seeded scenario generators


def random_failures(T: int, m: int, *, n_failures: int = 2,
                    n_straggles: int = 1, n_recoveries: int = 1,
                    straggle_speed: float = 0.3,
                    seed: int = 0) -> FaultSchedule:
    """Independent random failures/stragglers with partial recovery.

    Fail/straggle times are drawn from the middle of the stream
    ([T/4, 3T/4)) so every run has a pre-fault and post-fault regime;
    recoveries revive the earliest failures in the last quarter.  Same
    seed -> bit-identical schedule (regression-tested).
    """
    if n_failures + n_straggles >= m:
        raise ValueError(f"need n_failures + n_straggles < m, got "
                         f"{n_failures}+{n_straggles} >= {m}")
    rng = np.random.default_rng(seed)
    parts = rng.choice(m, size=n_failures + n_straggles, replace=False)
    lo, hi = max(T // 4, 1), max(3 * T // 4, 2)
    events = []
    for i, part in enumerate(parts):
        t = int(rng.integers(lo, hi))
        if i < n_failures:
            events.append(FaultEvent(t, int(part), "fail"))
        else:
            events.append(FaultEvent(t, int(part), "straggle",
                                     speed=straggle_speed))
    for part in parts[:min(n_recoveries, n_failures)]:
        t = int(rng.integers(max(3 * T // 4, 1), max(T, 2)))
        events.append(FaultEvent(t, int(part), "recover"))
    return FaultSchedule(m, events)


def rack_failure(T: int, m: int, *, rack_size: int = 2,
                 fail_at: int | None = None, recover_at: int | None = None,
                 seed: int = 0) -> FaultSchedule:
    """Correlated failure: one whole rack of consecutive parts dies at once.

    Parts are grouped into racks of ``rack_size`` consecutive indices; a
    random rack (never the whole cluster) fails at ``fail_at`` (default
    T//2) and optionally recovers at ``recover_at``.
    """
    if rack_size >= m:
        raise ValueError(f"rack_size {rack_size} must leave survivors "
                         f"(m={m})")
    rng = np.random.default_rng(seed)
    n_racks = m // rack_size
    rack = int(rng.integers(0, n_racks))
    t_fail = T // 2 if fail_at is None else int(fail_at)
    members = range(rack * rack_size,
                    min((rack + 1) * rack_size, m))
    events = [FaultEvent(t_fail, p, "fail") for p in members]
    if recover_at is not None:
        events += [FaultEvent(int(recover_at), p, "recover")
                   for p in members]
    return FaultSchedule(m, events)


FAULT_SCENARIOS = {
    "random-failures": random_failures,
    "rack-failure": rack_failure,
}


# ---------------------------------------------------------------------------
# capacity-aware host planner


def capacity_plan(gamma: np.ndarray, *, P: int, m: int, speeds=None,
                  optimal: bool = True) -> batch_device.Plan:
    """One frame's jagged plan over (possibly heterogeneous) capacity.

    The host-side twin of the device planner's P-stripe/m-interval shape:
    returns a :class:`batch_device.Plan` whose positional rectangle order
    matches the row-major sweep, so ``migrate`` diffs against device plans
    stay meaningful.  ``speeds=None`` (or all-equal) takes the
    homogeneous JAG-M-HEUR-PROBE path; heterogeneous speeds chunk the
    schedule by capacity (dead positions -> zero-width rectangles).
    ``optimal=True`` runs the exact multi-chain column solve (the "slow"
    degraded replan); ``False`` keeps the cheap per-chunk heuristic.
    """
    g = np.asarray(gamma, dtype=np.float64)
    n1, n2 = g.shape[0] - 1, g.shape[1] - 1
    sp = search.normalize_speeds(speeds, m)
    rp = np.ascontiguousarray(g[:, -1])
    if sp is None:
        P_eff = max(min(P, m, n1 if n1 > 0 else 1), 1)
        row_cuts = oned.optimal_1d(rp, P_eff)
        ps = [np.ascontiguousarray(g[row_cuts[s + 1]] - g[row_cuts[s]])
              for s in range(P_eff)]
        if optimal:
            _, _, col_cuts = oned.nicol_multi(ps, m)
        else:
            col_cuts = _heuristic_cols(ps, np.full(P_eff, m // P_eff)
                                       + (np.arange(P_eff) < m % P_eff),
                                       None)
    else:
        P_eff = max(min(P, m, int((sp > 0).sum()),
                        n1 if n1 > 0 else 1), 1)
        chunk = jagged._speed_chunks(sp, P_eff)
        gsum = np.add.reduceat(sp, chunk[:-1])
        row_cuts = oned.optimal_1d(rp, P_eff, speeds=gsum)
        ps = [np.ascontiguousarray(g[row_cuts[s + 1]] - g[row_cuts[s]])
              for s in range(P_eff)]
        if optimal:
            _, _, col_cuts = oned.nicol_multi(ps, m, speeds=sp)
        else:
            col_cuts = _heuristic_cols(
                ps, np.diff(chunk),
                [sp[chunk[s]:chunk[s + 1]] for s in range(P_eff)])
    counts = np.array([len(c) - 1 for c in col_cuts], dtype=np.int64)
    m_max = int(counts.max(initial=0))
    cc = np.full((P_eff, m_max + 1), n2, dtype=np.int64)
    for s, c in enumerate(col_cuts):
        cc[s, :len(c)] = c
    return batch_device.Plan(np.asarray(row_cuts, dtype=np.int64), counts,
                             cc, (n1, n2))


def _heuristic_cols(ps, counts, speed_slices):
    """Per-stripe independent column solves on a fixed interval split."""
    cuts = []
    for s, p in enumerate(ps):
        q = int(counts[s])
        sl = None if speed_slices is None else speed_slices[s]
        cuts.append(np.asarray(oned.optimal_1d(p, q, speeds=sl)))
    return cuts


def frame_capacity_plan(frame: np.ndarray, *, P: int, m: int, speeds=None,
                        optimal: bool = True) -> batch_device.Plan:
    """:func:`capacity_plan` on a raw (n1, n2) load frame."""
    return capacity_plan(prefix.prefix_sum_2d(np.asarray(frame)), P=P, m=m,
                         speeds=speeds, optimal=optimal)
