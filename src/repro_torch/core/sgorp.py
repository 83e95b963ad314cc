"""SGORP: subgradient-descent d-dimensional rectilinear partitioning.

The port of ``repro.core.sgorp`` (PAPERS.md, arXiv 2310.02470).  Cut
positions are continuous per-axis variables; each iteration

1. projects the d per-axis cut vectors back to sorted integer cuts,
2. evaluates every cell of the ``p1 x ... x pd`` grid in one gather over
   the d-dimensional Gamma (kernel K4 builds Gamma3 on the card) plus d
   ``torch.diff`` passes,
3. takes a subgradient step on the max-loaded cell's 2d bounding cuts —
   the lower cut of each axis moves up, the upper cut moves down, by a
   Newton-like step ``excess * width / (2d * Lmax)``.

The loop keeps the best projected integer cuts seen and stops after
``patience`` non-improving iterations (or ``max_iters``); iteration 0
evaluates the warm start itself, so the result is never worse than its
warm start, the optimal 1D partition of each axis' margin prefix
(``device.optimal_1d_device``).

The reference runs one ``lax.while_loop`` per frame under ``vmap``.  Here
the frame axis is written out: every function takes a ``(T, n1+1, ..,
nd+1)`` Gamma batch and ``(T, p_j+1)`` cut vectors, and the loop keeps
JAX's batched-while semantics exactly: the body runs while any lane's
``(t < max_iters) & (stall < patience)`` holds, and a lane whose
condition is false keeps its whole carry, so each lane's cuts, Lmax,
``iters`` and ``projections`` equal the reference's.  The loop reads one
flag from the device per iteration (``.any()``) and stops as soon as no
lane is live.

Heterogeneous ``speeds`` are supported in the same relative-load sense as
the reference: cell ``(i1, .., id)`` belongs to processor
``ravel(i1, .., id)`` (row-major) and the loop minimizes
``max(load / speed)``.  Speeds must be strictly positive.

Entry points (:func:`sgorp_2d`, :func:`sgorp_3d`) take ``device=None``,
which means the card, and raise ``RuntimeError`` where CUDA is absent.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import device as _device
from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.obs import trace as _trace
from repro_torch.obs.counters import C as _C

__all__ = ["default_grid", "sgorp_2d", "sgorp_3d", "sgorp_refine",
           "sgorp_refine_impl", "sgorp_plan_impl", "sgorp_plan_3d_impl",
           "warm_start_impl"]


def default_grid(m: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    """Factor ``m`` into ``len(shape)`` grid extents, as square as fits.

    Prime factors of m (largest first) go to the dimension with the
    smallest running factor that can still absorb them (``p_i <= n_i``);
    a prime that fits nowhere means no rectilinear m-cell grid exists.
    """
    d = len(shape)
    primes = []
    q, r = m, 2
    while r * r <= q:
        while q % r == 0:
            primes.append(r)
            q //= r
        r += 1
    if q > 1:
        primes.append(q)
    fac = [1] * d
    for pr in sorted(primes, reverse=True):
        cands = [i for i in range(d) if fac[i] * pr <= shape[i]]
        if not cands:
            raise ValueError(
                f"m={m} has no rectilinear grid within shape {shape}: "
                f"prime factor {pr} fits no dimension")
        i = min(cands, key=lambda c: fac[c])
        fac[i] *= pr
    return tuple(fac)


# ---------------------------------------------------------------------------
# the fixed-point loop, batched over frames


def _cell_loads(gamma: torch.Tensor, ics) -> torch.Tensor:
    """All grid-cell loads from one Gamma gather: index each axis at its
    cut positions, then one diff per axis in axis order (d-dim
    inclusion–exclusion).  gamma (T, n1+1, .., nd+1), ics d tensors
    (T, p_j+1) -> (T, p1, .., pd) in gamma's dtype."""
    T, d = gamma.shape[0], len(ics)
    idx = [torch.arange(T, device=gamma.device).view((T,) + (1,) * d)]
    for ax, ic in enumerate(ics):
        shape = [T] + [1] * d
        shape[1 + ax] = ic.shape[1]
        idx.append(ic.long().view(shape))
    sub = gamma[tuple(idx)]
    for ax in range(d):
        sub = torch.diff(sub, dim=1 + ax)
    return sub


def _project(x: torch.Tensor, n: int) -> torch.Tensor:
    """Continuous cuts (T, p+1) -> sorted, clipped integer cuts with
    pinned ends (int32)."""
    xi = torch.sort(torch.clamp(torch.round(x), 0, n), dim=1).values
    xi = xi.to(torch.int32)
    xi[:, 0] = 0
    xi[:, -1] = n
    return xi


def sgorp_refine_impl(gamma: torch.Tensor, warm, speed_grid=None, *, grid,
                      max_iters: int = 256, patience: int = 32):
    """The SGORP fixed-point loop for a batch of frames.

    gamma: (T, n1+1, .., nd+1) Gamma batch; warm: d integer cut tensors
    ((T, p_j+1) each, endpoints 0 / n_j); speed_grid: optional grid-shaped
    float32 per-cell speeds shared by every frame (relative-load
    objective).  Returns ``(cuts, Lmax, iters, projections)``: cuts, a
    tuple of d int32 (T, p_j+1) tensors, are the best projected integer
    cut vectors seen (never worse than ``warm``); Lmax is float32 (T,);
    ``projections`` counts iterations whose projection reached a new
    lattice point; iters and projections are int32 (T,).
    """
    d = len(grid)
    T = gamma.shape[0]
    shape = tuple(s - 1 for s in gamma.shape[1:])
    dev = gamma.device
    f32 = torch.float32
    total = gamma[(slice(None),) + (-1,) * d].to(f32)
    if speed_grid is None:
        ideal = total / math.prod(grid)
    else:
        ideal = total / speed_grid.sum().to(f32)
    strides = [math.prod(grid[j + 1:]) for j in range(d)]

    xs = [w.to(f32) for w in warm]
    best = [w.to(torch.int32) for w in warm]
    # prev deliberately != any projection so iteration 0 counts as one
    prev = [torch.full_like(b, -1) for b in best]
    best_L = torch.full((T,), math.inf, dtype=f32, device=dev)
    zero = torch.zeros(T, dtype=torch.int32, device=dev)
    t, stall, proj = zero, zero, zero

    while True:
        live = (t < max_iters) & (stall < patience)
        if not bool(live.any()):
            break
        ics = [_project(x, n) for x, n in zip(xs, shape)]
        loads = _cell_loads(gamma, ics).to(f32)
        rel = loads if speed_grid is None else loads / speed_grid
        rel = rel.reshape(T, -1)
        Lmax = rel.amax(dim=1)
        improved = Lmax < best_L
        changed = torch.stack([(ic != pv).any(dim=1)
                               for ic, pv in zip(ics, prev)]).any(dim=0)
        # subgradient step: shrink the max cell through all 2d faces
        arg = rel.argmax(dim=1)
        excess = torch.clamp_min(Lmax - ideal, 0.0)
        scale = 2 * d * torch.clamp_min(Lmax, 1e-6)
        new_xs = []
        for j in range(d):
            x = xs[j]
            lo_i = (arg // strides[j] % grid[j])[:, None]
            hi_i = lo_i + 1
            x_lo, x_hi = x.gather(1, lo_i), x.gather(1, hi_i)
            w = torch.clamp_min(x_hi - x_lo, 1e-6)
            delta = torch.minimum(
                torch.clamp_min(excess[:, None] * w / scale[:, None], 0.0),
                0.45 * w)
            x = x.scatter(1, lo_i, x_lo + delta * (lo_i > 0))
            x = x.scatter(1, hi_i, x_hi + -delta * (hi_i < grid[j]))
            new_xs.append(torch.sort(torch.clamp(x, 0.0, shape[j]),
                                     dim=1).values)
        # commit on the live lanes only (JAX's batched while_loop)
        keep = live & improved
        xs = [torch.where(live[:, None], nx, x) for nx, x in zip(new_xs, xs)]
        best = [torch.where(keep[:, None], ic, b) for ic, b in zip(ics, best)]
        prev = [torch.where(live[:, None], ic, pv)
                for ic, pv in zip(ics, prev)]
        best_L = torch.where(keep, Lmax, best_L)
        proj = proj + (live & changed).to(torch.int32)
        stall = torch.where(live, torch.where(improved, 0, stall + 1), stall)
        t = t + live.to(torch.int32)
    return tuple(best), best_L, t, proj


def warm_start_impl(gamma: torch.Tensor, *, grid, k: int = 8,
                    rounds: int = 8):
    """Rectilinear warm start: optimal 1D cuts of each axis margin prefix
    (the projection heuristic), on the Gamma batch's device.  Returns d
    int32 (T, p_j+1) cut tensors."""
    d = len(grid)
    cuts = []
    for j in range(d):
        p = gamma[(slice(None),) + tuple(slice(None) if ax == j else -1
                                         for ax in range(d))]
        c, _ = _device.optimal_1d_device(p.contiguous(), grid[j], k=k,
                                         rounds=rounds)
        cuts.append(c)
    return tuple(cuts)


def sgorp_plan_impl(gamma: torch.Tensor, speed_grid=None, *, grid,
                    max_iters: int = 256, patience: int = 32, k: int = 8,
                    rounds: int = 8):
    """Warm start + refine for a Gamma batch.  Returns (cuts tuple, Lmax,
    iters, projections)."""
    warm = warm_start_impl(gamma, grid=grid, k=k, rounds=rounds)
    return sgorp_refine_impl(gamma, warm, speed_grid, grid=grid,
                             max_iters=max_iters, patience=patience)


def sgorp_plan_3d_impl(frames: torch.Tensor, speed_grid=None, *, grid,
                       max_iters: int = 256, patience: int = 32,
                       k: int = 8, rounds: int = 8, gamma_dtype=None):
    """The batched 3D planning chain: (T, n1, n2, n3) frames -> stacked
    rectilinear cuts.  ingest -> Gamma3 (kernel K4 on the card) -> warm
    start + SGORP refine, all on the frames' device.  Returns (cuts1
    (T, p1+1), cuts2 (T, p2+1), cuts3 (T, p3+1), Lmax (T,), iters (T,),
    projections (T,))."""
    gamma_dtype = torch.float32 if gamma_dtype is None else gamma_dtype
    g = sat_ops.gamma3(frames.to(gamma_dtype))
    cuts, L, it, pr = sgorp_plan_impl(g, speed_grid, grid=grid,
                                      max_iters=max_iters,
                                      patience=patience, k=k, rounds=rounds)
    return cuts + (L, it, pr)


def sgorp_refine(gamma: torch.Tensor, warm, speed_grid=None, *, grid,
                 max_iters: int = 256, patience: int = 32):
    """Standalone refiner of one frame's Gamma (see
    :func:`sgorp_refine_impl`, which this runs as a batch of one): warm
    is d (p_j+1,) cut vectors; returns ((p_j+1,) cuts, Lmax, iters,
    projections) as 0-d or 1-d tensors."""
    cuts, L, it, pr = sgorp_refine_impl(
        gamma[None], [torch.as_tensor(w, device=gamma.device)[None]
                      for w in warm], speed_grid, grid=tuple(grid),
        max_iters=max_iters, patience=patience)
    return tuple(c[0] for c in cuts), L[0], it[0], pr[0]


# ---------------------------------------------------------------------------
# host entry points (registry adapters)


def _device_gamma_nd(gamma: np.ndarray, dev: torch.device) -> torch.Tensor:
    """int32/f32 device copy with the same overflow guard as the 2D
    registry adapter (int32 accumulators cap exact totals at 2**31)."""
    g = np.asarray(gamma)
    if np.issubdtype(g.dtype, np.integer):
        if int(g[(-1,) * g.ndim]) >= 2 ** 31:
            raise ValueError(
                f"total load {int(g[(-1,) * g.ndim])} overflows the device "
                f"refiner's int32 accumulators; pass a float load array")
        return torch.as_tensor(g.astype(np.int32), device=dev)
    return torch.as_tensor(g.astype(np.float32), device=dev)


def _run(gamma_host: np.ndarray, m: int, grid, speeds, max_iters, patience,
         device):
    """Shared host driver: resolve grid and device, plan, bump counters."""
    from repro_torch.rebalance.planner import resolve_device
    dev = resolve_device(device)
    d = gamma_host.ndim
    shape = tuple(s - 1 for s in gamma_host.shape)
    if grid is None:
        grid = default_grid(m, shape)
    grid = tuple(int(p) for p in grid)
    if math.prod(grid) != m:
        raise ValueError(f"grid {grid} has {math.prod(grid)} cells, "
                         f"need m={m}")
    if any(p > n for p, n in zip(grid, shape)):
        raise ValueError(f"grid {grid} exceeds shape {shape}")
    g = _device_gamma_nd(gamma_host, dev)
    speed_grid = None
    if speeds is not None:
        sp = np.asarray(speeds, np.float64)
        if (sp <= 0).any():
            # a fixed (p1 x ... x pd) processor grid cannot hand a dead
            # processor a zero-width cell; the slab algorithms can
            raise ValueError(
                "sgorp requires strictly positive speeds (its rectilinear "
                "grid has no zero-width cells for dead processors); use "
                "jag-m-heur-3d / jag-m-heur for speed=0 parts")
        speed_grid = torch.as_tensor(sp.reshape(grid).astype(np.float32),
                                     device=dev)
    with _trace.span("sgorp.refine", grid=str(grid), m=int(m)):
        cuts, _, it, pr = sgorp_plan_impl(g[None], speed_grid, grid=grid,
                                          max_iters=int(max_iters),
                                          patience=int(patience))
        cuts = [c[0].cpu().numpy().astype(np.int64) for c in cuts]
    _C.sgorp_iterations += int(it[0])
    _C.sgorp_projections += int(pr[0])
    return cuts


def sgorp_2d(gamma: np.ndarray, m: int, *,
             grid: tuple[int, int] | None = None, speeds=None,
             max_iters: int = 256, patience: int = 32, device=None):
    """Registry entry ``sgorp-2d``: rectilinear p1 x p2 partition of a 2D
    Gamma by the SGORP loop on ``device`` (``None``: the card); never
    worse than the per-axis 1D projection heuristic it warm-starts from."""
    from .types import from_grid
    gamma = np.asarray(gamma)
    rc, cc = _run(gamma, m, grid, speeds, max_iters, patience, device)
    return from_grid(rc, cc, (gamma.shape[0] - 1, gamma.shape[1] - 1))


def sgorp_3d(A: np.ndarray, m: int, *,
             grid: tuple[int, int, int] | None = None, speeds=None,
             max_iters: int = 256, patience: int = 32, device=None):
    """Registry entry ``sgorp-3d``: rectilinear p1 x p2 x p3 partition of
    a raw ``(n1, n2, n3)`` load volume (rank-3 registry convention) on
    ``device`` (``None``: the card)."""
    from .prefix import prefix_sum_3d
    from .threed import partition3d_from_grid
    A = np.asarray(A)
    cuts = _run(prefix_sum_3d(A), m, grid, speeds, max_iters, patience,
                device)
    return partition3d_from_grid(*cuts, shape=A.shape)
