"""The single-device stream planner as composable stages.

The port of ``repro.rebalance.planner`` for one card: a ``(T, n1, n2)``
frame stream goes through

    frame ingest -> SAT build (kernel K1) -> partition -> cut collect

with every intermediate (frames, Gammas) on the card and only the
O(T * m) cut vectors coming back to the host.  The partition stage is the
JAG-M-HEUR heuristic by default, or the exact JAG-PQ-OPT with
``exact=True`` (its column probes on kernel K2).

A ``(T, n1, n2, n3)`` volume stream (:func:`plan_stream_3d`, or
:func:`plan_stream` with rank-4 frames) goes through

    frame ingest -> 3D SAT build (kernel K4) -> SGORP warm start + refine

into a ``p1 x p2 x p3`` rectilinear processor grid per frame
(``core.sgorp``).

Entry points take ``device=None``, which means ``"cuda"``: they raise
``RuntimeError`` where CUDA is absent and run on the CPU only when the
caller passes ``device="cpu"``, as the tests do.

With ``mesh=`` (a ``dist.ctx.planner_mesh``) the stream is sharded by time
over the mesh's data-parallel devices, as the reference's ``shard_map``
path shards it: the frames are zero-padded along T to a multiple of the
device count D, cut into D contiguous shards, each shard runs the same
single-device chain on its own device, and the outputs are gathered onto
the mesh's first device in time order with the padding trimmed.  No
per-frame computation crosses the time axis and every batched loop
freezes a lane once it has converged, so the sharded plans are
bit-identical to the single-device plans on every mesh and every T.  One
process drives the devices in turn, as one controller drives the
reference's mesh.

``iter_plan_slices`` / ``plan_iter`` expose the stream lazily: every slice
is enqueued up front (CUDA launches are asynchronous, and the heuristic
path never waits on the card), so a policy loop consuming slice ``i``
overlaps with the card still planning slices ``i+1..``.

The graded replan decision (:func:`repro_torch.rebalance.policy.replan_mode`)
is re-exported here: planning and deciding-when-to-adopt are the two
halves of the planner API that ``rebalance.runtime`` and ``serve.batcher``
consume.
"""
from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from repro_torch.core import device, sgorp
from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.obs import trace as _trace
from repro_torch.rebalance.policy import replan_mode

__all__ = ["resolve_device", "resolve_gamma_dtype", "ingest_stage",
           "sat_stage", "partition_stage", "plan_frames", "plan_stream",
           "plan_frames_3d", "plan_stream_3d", "iter_plan_slices",
           "plan_iter", "plan_host", "profile_stages", "resolve_mesh",
           "replan_mode"]

# How many slices the lazy iterator aims for when none is requested: deep
# enough that the policy loop starts after ~1/4 of the stream is planned,
# shallow enough that per-slice dispatch overhead stays negligible.
_DEFAULT_SLICES = 4

# exact (int32) planning keeps every frame total below this, so greedy
# targets p + L cannot wrap
_EXACT_LIMIT = 2 ** 30
# the 3D path's int32 Gamma3 only has to hold the frame total (its warm
# start's greedy targets are float32)
_INT32_LIMIT = 2 ** 31


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, and
    asking for CUDA where it is absent raises ``RuntimeError`` — the port
    never carries on on the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on the card: CUDA is not "
                           "available (pass device='cpu' to run the plain "
                           "versions on the CPU)")
    return dev


def _to_device(frames, dev: torch.device) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames.to(dev)
    return torch.as_tensor(np.asarray(frames), device=dev)


def _check_finite(frames, t0: int, t1: int, *, what: str) -> None:
    """Refuse NaN/inf frames *before* they reach the device pipeline.

    A poisoned frame does not crash the partitioner — NaNs propagate
    through the SAT scan and the bisection silently produces garbage cuts
    for every frame sharing the slice — so ingest is the one place the
    corruption is still attributable.  Names the offending absolute
    time-steps and the slice they were batched into.
    """
    if isinstance(frames, torch.Tensor):
        if not frames.dtype.is_floating_point:
            return  # integer loads cannot encode NaN/inf
        bad = (~torch.isfinite(frames.reshape(frames.shape[0], -1))
               .all(dim=1)).cpu().numpy()
    else:
        arr = np.asarray(frames)
        if not np.issubdtype(arr.dtype, np.floating):
            return
        bad = ~np.isfinite(arr.reshape(arr.shape[0], -1)).all(axis=1)
    if bad.any():
        steps = (t0 + np.flatnonzero(bad)).tolist()
        shown = ", ".join(map(str, steps[:8]))
        more = f" (+{len(steps) - 8} more)" if len(steps) > 8 else ""
        raise ValueError(
            f"{what}: non-finite load frame(s) at step(s) {shown}{more} "
            f"in [{t0}, {t1}) — NaN/inf would silently corrupt every cut "
            f"in this slice; clean or drop the frames before planning")


def _check_rank(frames, what: str) -> None:
    if frames.ndim != 3:
        hint = (" (rank-3 volumes go through plan_stream or plan_stream_3d)"
                if frames.ndim == 4 else "")
        raise ValueError(f"{what} takes (T, n1, n2) frames, got rank "
                         f"{frames.ndim}{hint}")


# ---------------------------------------------------------------------------
# stages


def resolve_gamma_dtype(gamma_dtype, *, exact: bool) -> torch.dtype:
    """Accumulator dtype: explicit wins; else int32 (exact) / f32 (heur).

    The exact path bisects on *integers* — int32 accumulation is lossless
    up to 2**31 total load, where f32 already lies above 2**24 — while the
    heuristic path keeps its float32 default.
    """
    if gamma_dtype is not None:
        return gamma_dtype
    return torch.int32 if exact else torch.float32


def ingest_stage(frames: torch.Tensor, *, gamma_dtype=torch.float32,
                 limit: int = _EXACT_LIMIT) -> torch.Tensor:
    """Frame ingest: cast to the accumulator dtype *before* the SAT scan.

    Accumulation happens in ``gamma_dtype``: float32 saturates above 2**24
    total load; float64 keeps integer loads exact below 2**53 (the SAT
    kernel K1 takes it).  An int32 accumulator needs every frame total below ``limit``: 2**30 on
    the exact 2D path (its greedy targets p + L must not wrap), 2**31 on
    the 3D path.  Larger frames raise here, before the cast could wrap
    them.
    """
    if gamma_dtype == torch.int32:
        totals = frames.reshape(frames.shape[0], -1).sum(dim=1,
                                                         dtype=torch.int64)
        if totals.numel() and int(totals.max()) >= limit:
            raise ValueError(f"int32 planning needs every frame total below "
                             f"2**{limit.bit_length() - 1}, got "
                             f"{int(totals.max())}")
    return frames.to(gamma_dtype)


def sat_stage(frames: torch.Tensor) -> torch.Tensor:
    """SAT build: (T, n1, n2) frames -> (T, n1+1, n2+1) Gammas, on the
    frames' device (kernel K1 on the card)."""
    return sat_ops.gamma(frames)


def partition_stage(gammas: torch.Tensor, *, P: int, m: int, k: int = 8,
                    rounds: int = 8, gamma_dtype=None, exact: bool = False):
    """Partition every Gamma of the (T, n1+1, n2+1) batch.

    ``exact=False`` (default) runs JAG-M-HEUR; ``exact=True`` runs the
    exact JAG-PQ-OPT (``Q = m // P`` intervals per stripe), its column
    probes on the probe kernel.  Returns (row_cuts (T, P+1), counts
    (T, P), col_cuts (T, P, *), Lmax (T,)).
    """
    if exact:
        if m % P != 0:
            raise ValueError(
                f"exact planning needs m divisible by P (m={m}, P={P}): "
                f"the exact device solver is the P x Q form")
        return device.jag_pq_opt_device_impl(gammas, P=P, Q=m // P,
                                             k=max(k, 2))
    return device.jag_m_heur_device_impl(gammas, P=P, m=m, k=k,
                                         rounds=rounds,
                                         gamma_dtype=gamma_dtype)


def plan_frames(frames: torch.Tensor, *, P: int, m: int, k: int = 8,
                rounds: int = 8, gamma_dtype=None, exact: bool = False):
    """The full chain on the frames' device: ingest -> SAT -> partition.

    ``exact=True`` swaps the partition stage for the exact JAG-PQ-OPT and
    defaults the accumulator to int32 (see :func:`resolve_gamma_dtype`).
    """
    gamma_dtype = resolve_gamma_dtype(gamma_dtype, exact=exact)
    g = sat_stage(ingest_stage(frames, gamma_dtype=gamma_dtype))
    return partition_stage(g, P=P, m=m, k=k, rounds=rounds,
                           gamma_dtype=gamma_dtype, exact=exact)


def plan_frames_3d(frames: torch.Tensor, *, grid: tuple[int, ...],
                   max_iters: int = 256, patience: int = 32, k: int = 8,
                   rounds: int = 8, gamma_dtype=None):
    """The rank-3 chain on the frames' device: ingest -> 3D SAT -> SGORP.

    The volumetric twin of :func:`plan_frames` for ``(T, n1, n2, n3)``
    frame batches: one Gamma3 build (kernel K4 on the card), then the
    SGORP planner over the whole batch — per-axis 1D warm start refined
    by the subgradient fixed point (``core.sgorp``).  ``grid`` is the
    (p1, p2, p3) processor grid; ``gamma_dtype`` the accumulator (float32
    by default, or int32).  Returns ``(cuts1 (T, p1+1), cuts2, cuts3,
    Lmax (T,), iters (T,), projections (T,))``.
    """
    gamma_dtype = torch.float32 if gamma_dtype is None else gamma_dtype
    return sgorp.sgorp_plan_3d_impl(
        ingest_stage(frames, gamma_dtype=gamma_dtype, limit=_INT32_LIMIT),
        grid=grid, max_iters=max_iters, patience=patience, k=k,
        rounds=rounds, gamma_dtype=gamma_dtype)


# ---------------------------------------------------------------------------
# mesh execution


def resolve_mesh(mesh=None, devices=None, *, device=None):
    """Planner-mesh resolution for consumer-facing ``devices=`` knobs.

    An explicit mesh wins (it must be a ``dist.ctx.Mesh``, else
    ``TypeError``).  ``devices=N`` builds the 1-D ``dist.ctx.planner_mesh``
    over the first N CUDA devices, or over N entries of the CPU when
    ``device`` is the CPU (the counterpart of the reference's forced host
    devices); ``devices`` may also be a list of devices.  ``N=1`` or
    nothing means the single-device path (``None``).
    """
    from repro_torch.dist import ctx
    if mesh is not None:
        if not isinstance(mesh, ctx.Mesh):
            raise TypeError(f"mesh must be a repro_torch.dist.ctx.Mesh "
                            f"(dist.ctx.planner_mesh), got "
                            f"{type(mesh).__name__}")
        return mesh
    if devices is None:
        return None
    if isinstance(devices, bool) or not isinstance(devices, int):
        if isinstance(devices, (str, torch.device)):
            raise TypeError("devices= takes a device count or a list of "
                            "devices, not one device")
        return ctx.planner_mesh(devices=[resolve_device(d) for d in devices])
    if devices <= 1:
        return None
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ctx.planner_mesh(devices=[dev] * devices)
    return ctx.planner_mesh(devices)


def _dp_spec(mesh) -> tuple[torch.device, ...]:
    """The devices the time axis is sharded over, in order: the mesh's
    data-parallel axis (checked by ``dist.ctx.planner_axes``)."""
    from repro_torch.dist import ctx
    ctx.planner_axes(mesh)
    return tuple(resolve_device(d) for d in mesh.devices)


def _pad_time(frames, T_pad: int):
    """``frames`` (array or tensor) zero-padded along axis 0 to ``T_pad``."""
    T = frames.shape[0]
    if T_pad == T:
        return frames
    if isinstance(frames, torch.Tensor):
        return torch.cat([frames, frames.new_zeros((T_pad - T,)
                                                   + frames.shape[1:])])
    arr = np.asarray(frames)
    return np.concatenate([arr, np.zeros((T_pad - T,) + arr.shape[1:],
                                         arr.dtype)])


def _sharded(frames, mesh, chain) -> tuple:
    """Run ``chain`` (frames on one device -> tuple of per-frame tensors)
    over ``mesh``: zero-pad T to a multiple of the device count D, give
    shard i (frames ``[i T/D, (i+1) T/D)``) to device i, gather the outputs
    onto the first device in time order and trim the padding."""
    devs = _dp_spec(mesh)
    T, D = frames.shape[0], len(devs)
    per = -(-T // D)
    padded = _pad_time(frames, per * D)
    outs = [chain(_to_device(padded[i * per:(i + 1) * per], dev))
            for i, dev in enumerate(devs)]
    return tuple(torch.cat([o[j].to(devs[0]) for o in outs])[:T]
                 for j in range(len(outs[0])))


def _run(frames, mesh, device, chain) -> tuple:
    """``chain`` on ``device``, or sharded over ``mesh`` when there is one."""
    if mesh is not None:
        return _sharded(frames, mesh, chain)
    return chain(_to_device(frames, resolve_device(device)))


def plan_stream_3d(frames, *, m: int, grid: tuple[int, ...] | None = None,
                   mesh=None, max_iters: int = 256, patience: int = 32,
                   k: int = 8, rounds: int = 8, gamma_dtype=None,
                   device=None):
    """SGORP planning for a whole (T, n1, n2, n3) volume stream.

    The rank-3 twin of :func:`plan_stream`.  ``frames`` is a numpy array
    or a tensor; it is moved to ``device`` (``None``: the card), or, with
    a ``mesh``, sharded by time over the mesh's devices (cuts bit-identical
    to one device; a zero-padded frame converges trivially and is
    discarded).  ``grid=None`` derives the (p1, p2, p3) processor grid
    from ``m`` via :func:`repro_torch.core.sgorp.default_grid`.
    ``gamma_dtype`` is the accumulator of Gamma3 and the warm start:
    float32 (default), float64 or int32; the refiner works in float32
    whatever it is, as the reference's.  Returns the stacked ``(cuts1,
    cuts2, cuts3, Lmax, iters, projections)`` tensors on that device (the
    mesh's first).
    """
    mesh = resolve_mesh(mesh)
    if frames.ndim != 4:
        raise ValueError(
            f"plan_stream_3d takes (T, n1, n2, n3) frames, got rank "
            f"{frames.ndim}")
    _check_finite(frames, 0, frames.shape[0], what="plan_stream_3d")
    if grid is None:
        grid = sgorp.default_grid(m, tuple(frames.shape[1:]))
    grid = tuple(int(g) for g in grid)
    if math.prod(grid) != m:
        raise ValueError(f"grid {grid} has {math.prod(grid)} cells, "
                         f"expected m={m}")
    return _run(frames, mesh, device, functools.partial(
        plan_frames_3d, grid=grid, max_iters=max_iters, patience=patience,
        k=k, rounds=rounds, gamma_dtype=gamma_dtype))


def plan_stream(frames, *, P: int, m: int, mesh=None, k: int = 8,
                rounds: int = 8, gamma_dtype=None, exact: bool = False,
                device=None):
    """SAT + partitioner for a whole (T, n1, n2) stream.

    ``frames`` is a numpy array or a tensor; it is moved to ``device``
    (``None``: the card).  Returns the batched (row_cuts, counts,
    col_cuts, Lmax) tensors on that device.  ``exact=True`` plans every
    frame with the exact JAG-PQ-OPT (``Q = m // P``).  With a ``mesh``
    the time axis is sharded over the mesh's devices (see the module
    docstring) and the result lands on its first device, bit-identical to
    the single-device result.

    Rank-4 ``(T, n1, n2, n3)`` frames route to :func:`plan_stream_3d`
    (the SGORP chain): ``P`` — a 2D stripe count — is ignored there; the
    (p1, p2, p3) processor grid is derived from ``m``.
    """
    if frames.ndim == 4:
        if exact:
            raise ValueError(
                "exact=True has no rank-3 solver; the 3D path plans with "
                "the SGORP refiner (plan_stream_3d)")
        return plan_stream_3d(frames, m=m, mesh=mesh, k=k, rounds=rounds,
                              gamma_dtype=gamma_dtype, device=device)
    mesh = resolve_mesh(mesh)
    _check_rank(frames, "plan_stream")
    _check_finite(frames, 0, frames.shape[0], what="plan_stream")
    return _run(frames, mesh, device, functools.partial(
        plan_frames, P=P, m=m, k=k, rounds=rounds, gamma_dtype=gamma_dtype,
        exact=exact))


# ---------------------------------------------------------------------------
# lazy per-slice consumption


def iter_plan_slices(frames, *, P: int, m: int, mesh=None,
                     slice_size: int | None = None, k: int = 8,
                     rounds: int = 8, gamma_dtype=None, exact: bool = False,
                     device=None):
    """Yield ``(t0, t1, batched_slice)`` over the stream, planned lazily.

    All slices are enqueued before the first yield, so a consumer working
    through slice ``i``'s cuts overlaps with the card still planning
    slices ``i+1..`` (the exact path reads one flag per bisection round,
    so there the enqueue itself waits on the card).  On a mesh of D
    devices every slice is sharded over the mesh, and ``slice_size`` is
    rounded up to a multiple of D, as the reference rounds it.
    """
    mesh = resolve_mesh(mesh)
    _check_rank(frames, "iter_plan_slices")
    T = frames.shape[0]
    D = 1 if mesh is None else len(_dp_spec(mesh))
    if slice_size is None:
        slice_size = max(D, -(-T // _DEFAULT_SLICES))
    slice_size = -(-slice_size // D) * D
    chain = functools.partial(plan_frames, P=P, m=m, k=k, rounds=rounds,
                              gamma_dtype=gamma_dtype, exact=exact)
    pending = []
    for i, t0 in enumerate(range(0, T, slice_size)):
        t1 = min(t0 + slice_size, T)
        _check_finite(frames[t0:t1], t0, t1, what=f"planner slice {i}")
        # host-side span: measures the enqueue only, so instrumentation
        # never serializes the slice overlap
        with _trace.span("planner.dispatch", slice=i, t0=t0, t1=t1):
            pending.append((t0, t1, _run(frames[t0:t1], mesh, device,
                                         chain)))
    yield from pending


def plan_iter(frames, *, P: int, m: int, mesh=None,
              slice_size: int | None = None, k: int = 8, rounds: int = 8,
              gamma_dtype=None, exact: bool = False, device=None):
    """Per-frame :class:`~repro_torch.rebalance.batch_device.Plan` iterator.

    The lazy flattening of :func:`iter_plan_slices` — what a policy loop
    consumes in lockstep with the frames.
    """
    from repro_torch.rebalance import batch_device
    shape = tuple(frames.shape[1:])
    for t0, t1, batched in iter_plan_slices(
            frames, P=P, m=m, mesh=mesh, slice_size=slice_size, k=k,
            rounds=rounds, gamma_dtype=gamma_dtype, exact=exact,
            device=device):
        # collect blocks on the slice's results (the first host read) —
        # its span width is the wait the policy loop actually saw
        with _trace.span("planner.collect", t0=t0, t1=t1):
            plans = batch_device.unstack_plans(batched, shape)
        yield from plans


def plan_host(frames, *, P: int, m: int, mesh=None, k: int = 8,
              rounds: int = 8, gamma_dtype=None, exact: bool = False,
              device=None):
    """Whole-stream planning to host Plans (one dispatch, no slicing)."""
    from repro_torch.rebalance import batch_device
    _check_rank(frames, "plan_host")
    batched = plan_stream(frames, P=P, m=m, mesh=mesh, k=k, rounds=rounds,
                          gamma_dtype=gamma_dtype, exact=exact,
                          device=device)
    return batch_device.unstack_plans(batched, tuple(frames.shape[1:]))


def profile_stages(frames, *, P: int, m: int, k: int = 8, rounds: int = 8,
                   gamma_dtype=None, exact: bool = False, mesh=None,
                   device=None) -> tuple[list, dict[str, float]]:
    """Blocking per-stage timing of the planning chain (opt-in profiler).

    Runs the stages one by one and waits for the device after each
    (``torch.cuda.synchronize`` on the card) to attribute wall time to the
    named stages.  Returns ``(plans, timings)``: the same per-frame Plans
    as :func:`plan_host` and a ``{"ingest", "sat", "partition",
    "collect"} -> seconds`` dict.  ``ingest`` includes the upload of the
    frames to the device.  On a mesh the whole sharded chain is timed as
    one stage, charged to ``partition``, as the reference charges it.
    """
    from repro_torch.rebalance import batch_device
    mesh = resolve_mesh(mesh)
    _check_rank(frames, "profile_stages")
    devs = (resolve_device(device),) if mesh is None else _dp_spec(mesh)
    _check_finite(frames, 0, frames.shape[0], what="profile_stages")
    shape = tuple(frames.shape[1:])
    timings: dict[str, float] = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        with _trace.span(f"planner.stage.{name}"):
            out = fn(*a)
            for d in set(devs):
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        timings[name] = time.perf_counter() - t0
        return out

    if mesh is not None:
        out = timed("partition", lambda f: plan_stream(
            f, P=P, m=m, mesh=mesh, k=k, rounds=rounds,
            gamma_dtype=gamma_dtype, exact=exact), frames)
    else:
        dev = devs[0]
        gd = resolve_gamma_dtype(gamma_dtype, exact=exact)
        ing = timed("ingest", lambda f: ingest_stage(_to_device(f, dev),
                                                     gamma_dtype=gd), frames)
        g = timed("sat", sat_stage, ing)
        out = timed("partition", lambda x: partition_stage(
            x, P=P, m=m, k=k, rounds=rounds, gamma_dtype=gd, exact=exact),
            g)
    t0 = time.perf_counter()
    with _trace.span("planner.stage.collect"):
        plans = batch_device.unstack_plans(out, shape)
    timings["collect"] = time.perf_counter() - t0
    return plans, timings
