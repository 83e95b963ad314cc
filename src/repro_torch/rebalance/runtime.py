"""Time-stepped rebalancing runtime over the frame planner on the card.

The execution model (paper Section 6): a frame costs its bottleneck load
(the step takes as long as the busiest processor), and adopting a new plan
costs ``replan_overhead + alpha * migration_volume``.  Candidate plans for
*every* frame come from the planner (``repro_torch.rebalance.planner``)
— either one ``plan_host`` call over the whole stream or, by default, the
planner's **lazy per-slice iterator**: slices are all enqueued up front
and the policy loop consumes slice 0's cuts while the card is still
planning the rest, instead of blocking on the full stream.  Either way
the load matrices never leave the card; the host only touches O(m) cut
vectors and the owner maps it diffs.

``compare_policies`` runs several policies over the same precomputed
candidate plans, which is how the never/always/hysteresis trade-off
(Fig. 4's motivation) is measured in the benchmarks and tests.

The port of ``repro.rebalance.runtime``: the same ledger on the same
frames.  Entry points take ``device=None``, which means the card (see
``planner.resolve_device``), and ``gamma_dtype`` for the planner's
accumulators (float32 by default, as the reference plans; float64 keeps
integer loads exact below 2**53).  The sharded planner is not ported:
``mesh`` must be None and ``devices`` None or 1, and migrations execute
on one device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import prefix, search
from repro_torch.obs import trace as _trace

from . import batch_device, migrate, planner
from .policy import StepState, replan_mode

__all__ = ["StepRecord", "RunResult", "plan_stream_host", "run_stream",
           "compare_policies"]


@dataclasses.dataclass(frozen=True)
class StepRecord:
    step: int
    max_load: float          # bottleneck of the plan active *after* this step's decision
    ideal: float             # total / m
    replanned: bool
    migration_volume: float  # weight moved this step (0 unless replanned)
    migration_cost: float    # alpha * (volume + evacuation) + overhead
    evacuation_volume: float = 0.0  # weight pulled off dead parts this step
    forced: bool = False     # a failure forced this replan (policy bypassed)
    mode: str = "keep"       # replan grade: "init" | "keep" | "fast" | "slow"
    wall_time: float = 0.0   # measured host seconds spent on this step
    churn: dict | None = None  # per_processor_churn of the adopted replan
    executed_bytes: float | None = None  # measured weight moved when the
    # migration was actually executed (run_stream(execute=True)); None
    # when only priced.  Equals migration_volume exactly on integer
    # streams — see repro_torch.rebalance.execute.


@dataclasses.dataclass
class RunResult:
    records: list[StepRecord]
    final_plan: batch_device.Plan

    @property
    def compute_cost(self) -> float:
        return sum(r.max_load for r in self.records)

    @property
    def migration_cost(self) -> float:
        return sum(r.migration_cost for r in self.records)

    @property
    def total_cost(self) -> float:
        return self.compute_cost + self.migration_cost

    @property
    def n_replans(self) -> int:
        return sum(r.replanned for r in self.records[1:])  # t=0 is free

    @property
    def n_forced(self) -> int:
        return sum(r.forced for r in self.records)

    @property
    def evacuation_volume(self) -> float:
        return sum(r.evacuation_volume for r in self.records)

    @property
    def mean_imbalance(self) -> float:
        lis = [r.max_load / r.ideal - 1.0 for r in self.records
               if r.ideal > 0]
        return float(np.mean(lis)) if lis else 0.0

    def summary(self) -> str:
        return (f"total={self.total_cost:.3g} "
                f"(compute={self.compute_cost:.3g}, "
                f"migrate={self.migration_cost:.3g}) "
                f"replans={self.n_replans} "
                f"LI_mean={self.mean_imbalance * 100:.2f}%")

    def trace_events(self, *, pid: int = 0, scale: float = 1.0) -> list[dict]:
        """Chrome ``trace_event`` view of the run ledger.

        Two timelines per record: tid 0 is the *virtual* compute timeline
        (each step an "X" slice whose duration is ``max_load * scale`` us
        — slice widths show the bottleneck the paper's cost model
        charges), tid 1 carries the measured host wall-time of the same
        step.  Replans add instant markers with their grade, volume and
        cost (plus evacuation when forced).  Feed the result to
        :func:`repro_torch.obs.chrome_trace` / ``write_chrome_trace``.
        """
        ev: list[dict] = []
        ts_v = ts_w = 0.0
        for r in self.records:
            dur_v = float(r.max_load) * scale
            ev.append({"name": f"step[{r.step}]", "ph": "X", "pid": pid,
                       "tid": 0, "ts": ts_v, "dur": dur_v,
                       "args": {"ideal": r.ideal, "mode": r.mode}})
            if r.replanned:
                iargs = {"mode": r.mode, "volume": r.migration_volume,
                         "cost": r.migration_cost}
                if r.forced:
                    iargs["forced"] = True
                    iargs["evacuation"] = r.evacuation_volume
                ev.append({"name": "replan", "ph": "i", "s": "t",
                           "pid": pid, "tid": 0, "ts": ts_v, "args": iargs})
            ev.append({"name": f"host.step[{r.step}]", "ph": "X",
                       "pid": pid, "tid": 1, "ts": ts_w,
                       "dur": r.wall_time * 1e6})
            ts_v += dur_v
            ts_w += r.wall_time * 1e6
        return ev


def plan_stream_host(frames: np.ndarray, *, P: int, m: int, k: int = 8,
                     rounds: int = 8, gamma_dtype=torch.float32, mesh=None,
                     devices: int | None = None,
                     device=None) -> list[batch_device.Plan]:
    """Candidate plan per frame via one planner call."""
    planner._check_mesh(mesh, devices)
    return planner.plan_host(np.asarray(frames), P=P, m=m, k=k,
                             rounds=rounds, gamma_dtype=gamma_dtype,
                             device=device)


def _rel_max(plan: batch_device.Plan, g: np.ndarray, sp) -> float:
    """Plan bottleneck on ``g``: raw load, or relative load under hetero
    speeds (a loaded dead part costs ``inf`` — its work never finishes)."""
    if sp is None:
        return plan.max_load(g)
    loads = np.asarray(plan.loads(g), dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(loads > 0, loads / sp[:loads.size], 0.0)
    return float(rel.max(initial=0.0))


def _execute_device(execute_devices, dev: torch.device) -> torch.device:
    """The one device migrations execute on: ``None`` (the run's device)
    or a single device; more than one needs the multi-device execution,
    not ported yet."""
    if execute_devices is None:
        return dev
    if isinstance(execute_devices, (list, tuple)):
        if len(execute_devices) != 1:
            raise NotImplementedError(
                "executing migrations across several devices is not "
                "ported yet; pass execute_devices=None or one device")
        execute_devices = execute_devices[0]
    return planner.resolve_device(execute_devices)


def run_stream(frames: np.ndarray, policy, *, P: int, m: int,
               alpha: float = 1.0, replan_overhead: float = 0.0,
               weight: str = "load", plans=None,
               gammas: list[np.ndarray] | None = None, k: int = 8,
               rounds: int = 8, mesh=None, devices: int | None = None,
               faults=None, validate: bool = False, execute: bool = False,
               execute_devices=None, gamma_dtype=None,
               device=None) -> RunResult:
    """Drive one policy over a (T, n1, n2) stream.

    weight: "load" charges migration by the moved cells' current load
    (state size tracks load in PIC-like codes); "cells" charges per cell.
    Step 0's initial placement is free — every policy pays it equally.

    ``plans`` may be a list or any iterable of per-frame Plans; when
    omitted, the planner's lazy slice iterator supplies them on
    ``device`` (``None``: the card), with ``gamma_dtype`` accumulators,
    so the policy loop overlaps with later slices' planning.  ``gammas``
    are the per-frame host prefix tables used for exact cost accounting;
    pass them (with ``plans``) when replaying the same stream under
    several policies — see :func:`compare_policies`.  When omitted they
    are built per step, keeping the loop lazy.

    ``faults`` is an optional
    :class:`repro_torch.rebalance.faults.FaultSchedule`.
    While any processor runs degraded, bottlenecks are *relative* loads
    (``load_i / speed_i``; a loaded dead part costs ``inf``) against the
    surviving-capacity ideal, and candidate plans come from the
    capacity-aware host planner (:func:`repro_torch.rebalance.faults
    .capacity_plan`) instead of the homogeneous device stream.  An
    outright failure *forces* an immediate degraded replan whatever the
    policy says (the active plan still routes work to a dead part);
    stragglers and recoveries only set ``StepState.capacity_changed`` and
    let the policy's :func:`~repro_torch.rebalance.policy.replan_mode`
    grade keep/fast/slow.  Every replan additionally charges
    ``alpha * evacuation_volume`` — the weight pulled off dead parts
    (``migrate.migration_matrix`` rows), which is paid on top of ordinary
    migration because a dead machine's state must be recovered rather
    than copied.

    ``validate=True`` runs :meth:`batch_device.Plan.validate` on every
    adopted plan (coverage/monotonicity/load-conservation).

    ``execute=True`` *performs* every adopted replan's migration through
    :func:`repro_torch.rebalance.execute.execute_migration` — owner-changed
    cells' weights are moved through ``execute_devices`` (``None``: the
    run's device; one device at most) and the measured total lands in
    ``StepRecord.executed_bytes``, auditing the priced
    ``migration_volume`` against real transfers.
    """
    if weight not in ("load", "cells"):
        raise ValueError(f"weight must be 'load' or 'cells', got {weight!r}")
    planner._check_mesh(mesh, devices)
    dev = planner.resolve_device(device)
    exec_dev = _execute_device(execute_devices, dev) if execute else None
    frames = np.asarray(frames)
    if plans is None:
        plans = planner.plan_iter(frames, P=P, m=m, k=k, rounds=rounds,
                                  gamma_dtype=gamma_dtype, device=dev)
    plan_it = iter(plans)
    if faults is not None:
        from . import faults as faults_mod
        if faults.m != m:
            raise ValueError(f"fault schedule is for m={faults.m}, "
                             f"run_stream got m={m}")

    def next_plan(t: int) -> batch_device.Plan:
        # a bare StopIteration would read as normal termination to any
        # enclosing generator — surface short plan streams loudly instead
        plan = next(plan_it, None)
        if plan is None:
            raise ValueError(f"plans ran out at step {t}: run_stream needs "
                             f"one candidate plan per frame "
                             f"({len(frames)} frames)")
        return plan

    def frame_gamma(t: int) -> np.ndarray:
        return gammas[t] if gammas is not None \
            else prefix.prefix_sum_2d(frames[t])

    def speeds_state(t: int):
        """(normalized speeds | None, ideal denominator, events at t)."""
        if faults is None:
            return None, float(m), []
        raw = faults.speeds_at(t)
        sp = search.normalize_speeds(raw, m)
        denom = float(raw.sum()) if sp is not None else float(m)
        return sp, denom, faults.events_at(t)

    records: list[StepRecord] = []
    t_wall = time.perf_counter()
    with _trace.span("runtime.step", t=0):
        active = next_plan(0)
        g0 = frame_gamma(0)
        sp, denom, _ = speeds_state(0)
        if sp is not None:
            active = faults_mod.capacity_plan(g0, P=P, m=m, speeds=sp,
                                              optimal=True)
        if validate:
            active.validate(g0, m=m)
        achieved = _rel_max(active, g0, sp)
    total_at_replan = float(g0[-1, -1])
    steps_since = 0
    last_volume = 0.0
    records.append(StepRecord(0, achieved, total_at_replan / denom, True,
                              0.0, 0.0, mode="init",
                              wall_time=time.perf_counter() - t_wall))
    for t in range(1, len(frames)):
        t_wall = time.perf_counter()
        with _trace.span("runtime.step", t=t) as _sp:
            candidate = next_plan(t)
            g = frame_gamma(t)
            total = float(g[-1, -1])
            sp, denom, events = speeds_state(t)
            cur_ml = _rel_max(active, g, sp)
            steps_since += 1
            ideal = total / denom
            state = StepState(step=t, max_load=cur_ml, ideal=ideal,
                              total_load=total, achieved_at_replan=achieved,
                              total_at_replan=total_at_replan,
                              steps_since_replan=steps_since,
                              last_migration_volume=last_volume, alpha=alpha,
                              replan_overhead=replan_overhead,
                              capacity_changed=bool(events))
            forced = any(e.kind == "fail" for e in events)
            mode = "slow" if forced else replan_mode(policy, state)
            _sp.args["mode"] = mode
            if forced or mode != "keep":
                if sp is not None:
                    candidate = faults_mod.capacity_plan(
                        g, P=P, m=m, speeds=sp,
                        optimal=forced or mode == "slow")
                w = frames[t] if weight == "load" else None
                flow = migrate.migration_matrix(active, candidate,
                                                weights=w)
                vol = float(flow.sum())
                evac = 0.0
                if faults is not None:
                    dead = faults.failed_at(t)
                    if dead.size:
                        evac = float(flow[dead, :].sum())
                churn = migrate.per_processor_churn(flow=flow)
                cost = replan_overhead + alpha * (vol + evac)
                executed = None
                if execute:
                    from . import execute as execute_mod
                    receipt = execute_mod.execute_migration(
                        active, candidate,
                        weights=frames[t] if weight == "load" else None,
                        device=exec_dev)
                    executed = receipt.executed_bytes
                active = candidate
                if validate:
                    active.validate(g, m=m)
                achieved = _rel_max(active, g, sp)
                total_at_replan = total
                steps_since = 0
                last_volume = vol
                records.append(StepRecord(
                    t, achieved, ideal, True, vol, cost, evac, forced,
                    mode=mode, wall_time=time.perf_counter() - t_wall,
                    churn=churn, executed_bytes=executed))
            else:
                records.append(StepRecord(
                    t, cur_ml, ideal, False, 0.0, 0.0, mode="keep",
                    wall_time=time.perf_counter() - t_wall))
    return RunResult(records, active)


def compare_policies(frames: np.ndarray, policies: dict, *, P: int, m: int,
                     alpha: float = 1.0, replan_overhead: float = 0.0,
                     weight: str = "load", k: int = 8, rounds: int = 8,
                     mesh=None, devices: int | None = None, faults=None,
                     validate: bool = False, gamma_dtype=None,
                     device=None) -> dict[str, RunResult]:
    """Run several policies over shared precomputed plans and gammas.

    The plans are materialized once (replayed per policy), but still
    arrive through the lazy slice iterator: the first policy's gamma
    precompute overlaps with the tail slices' planning.  ``faults`` /
    ``validate`` pass through to :func:`run_stream` (every policy sees
    the same fault schedule).
    """
    planner._check_mesh(mesh, devices)
    dev = planner.resolve_device(device)
    frames = np.asarray(frames)
    plan_it = planner.plan_iter(frames, P=P, m=m, k=k, rounds=rounds,
                                gamma_dtype=gamma_dtype, device=dev)
    first = next(plan_it, None)  # enqueues every slice up front
    gammas = [prefix.prefix_sum_2d(f) for f in frames]
    plans = ([] if first is None else [first]) + list(plan_it)
    return {name: run_stream(frames, pol, P=P, m=m, alpha=alpha,
                             replan_overhead=replan_overhead, weight=weight,
                             plans=plans, gammas=gammas, faults=faults,
                             validate=validate, device=dev)
            for name, pol in policies.items()}
