"""Time-evolving workload streams (the paper's Fig. 4 regime and beyond).

Each 2D generator returns a ``(T, n1, n2)`` int64 batch of load frames with
strictly positive cells — the input shape ``batch_device.plan_stream``
consumes.  The PIC series reproduces the paper's every-500-iterations
experiment; the others exercise regimes the paper motivates but does not
simulate: smooth drift (hotspots), rotation/advection (particles), and
spatially abrupt change (AMR-style refinement bursts) — the case where
hysteresis policies earn their keep.

The 3D generators (``STREAMS_3D``) return ``(T, n1, n2, n3)`` volumes
for the rank-3 planner (``planner.plan_stream_3d``).

The port's NumPy copy of ``repro.rebalance.stream``: the same seed gives
the same frames in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import prefix

__all__ = ["drifting_hotspot", "particle_advection", "refinement_bursts",
           "pic_series", "static", "STREAMS", "pic_series_3d",
           "amr_series_3d", "STREAMS_3D"]


def drifting_hotspot(T: int, n1: int, n2: int, *, n_hotspots: int = 2,
                     amplitude: float = 8.0, width: float = 0.10,
                     speed: float = 0.6, base: int = 50, noise: bool = True,
                     seed: int = 0) -> np.ndarray:
    """Gaussian hotspots translating across the grid (smooth drift).

    Each hotspot starts at a random cell and moves in a straight line,
    reflecting off the walls; ``speed`` is the fraction of the grid a
    hotspot crosses over the T frames.  ``noise`` Poisson-samples the
    density field (deterministic rounding otherwise).
    """
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.15, 0.85, (n_hotspots, 2))
    ang = rng.uniform(0, 2 * np.pi, n_hotspots)
    vel = np.stack([np.cos(ang), np.sin(ang)], axis=1) * speed / max(T - 1, 1)
    ii, jj = np.meshgrid(np.arange(n1) / n1, np.arange(n2) / n2,
                         indexing="ij")
    frames = np.empty((T, n1, n2), dtype=np.int64)
    for t in range(T):
        # reflect positions into [0, 1]
        q = np.abs((pos + vel * t) % 2.0)
        q = np.where(q > 1.0, 2.0 - q, q)
        dens = np.zeros((n1, n2))
        for h in range(n_hotspots):
            d2 = (ii - q[h, 0]) ** 2 + (jj - q[h, 1]) ** 2
            dens += np.exp(-d2 / (2 * width ** 2))
        field = base * (1.0 + amplitude * dens)
        frames[t] = rng.poisson(field) if noise else np.round(field)
        np.maximum(frames[t], 1, out=frames[t])
    return frames


def particle_advection(T: int, n1: int, n2: int, *,
                       n_particles: int = 200_000, omega: float = 1.0,
                       drift: float = 0.3, base: int = 1,
                       seed: int = 0) -> np.ndarray:
    """Particles in a solid-body vortex plus a uniform drift, deposited
    per frame (nearest-cell).  ``omega`` is total revolutions over the run;
    ``drift`` the fraction of the grid the cloud translates.
    """
    rng = np.random.default_rng(seed)
    # two clumps + a diffuse background, in unit coordinates
    k = n_particles // 4
    pts = np.concatenate([
        rng.normal([0.30, 0.40], 0.06, (k, 2)),
        rng.normal([0.65, 0.60], 0.09, (k, 2)),
        rng.uniform(0, 1, (n_particles - 2 * k, 2)),
    ])
    frames = np.empty((T, n1, n2), dtype=np.int64)
    for t in range(T):
        th = 2 * np.pi * omega * t / max(T - 1, 1)
        c, s = np.cos(th), np.sin(th)
        rel = pts - 0.5
        rot = np.stack([c * rel[:, 0] - s * rel[:, 1],
                        s * rel[:, 0] + c * rel[:, 1]], axis=1) + 0.5
        rot[:, 0] += drift * t / max(T - 1, 1)
        idx = (np.clip(rot[:, 0] % 1.0, 0, 1 - 1e-9) * n1).astype(np.int64)
        jdx = (np.clip(rot[:, 1] % 1.0, 0, 1 - 1e-9) * n2).astype(np.int64)
        a = np.full((n1, n2), base, dtype=np.int64)
        np.add.at(a, (idx, jdx), 1)
        frames[t] = a
    return frames


def refinement_bursts(T: int, n1: int, n2: int, *, burst_every: int = 6,
                      burst_len: int = 4, factor: int = 16,
                      patch_frac: float = 0.2, base_lo: int = 8,
                      base_hi: int = 16, seed: int = 0) -> np.ndarray:
    """AMR-style refinement: random rectangular patches abruptly multiply
    their load by ``factor`` for ``burst_len`` frames, then relax.

    The discontinuous jumps (unlike the smooth streams) are what force a
    replanning policy to distinguish transients from persistent shifts.
    """
    rng = np.random.default_rng(seed)
    baseA = rng.integers(base_lo, base_hi + 1, (n1, n2)).astype(np.int64)
    frames = np.empty((T, n1, n2), dtype=np.int64)
    active: list[tuple[int, tuple[int, int, int, int]]] = []
    for t in range(T):
        if t % burst_every == 0:
            h = max(int(n1 * patch_frac), 1)
            w = max(int(n2 * patch_frac), 1)
            r0 = int(rng.integers(0, n1 - h + 1))
            c0 = int(rng.integers(0, n2 - w + 1))
            active.append((t, (r0, r0 + h, c0, c0 + w)))
        active = [(t0, q) for t0, q in active if t - t0 < burst_len]
        a = baseA.copy()
        for _, (r0, r1, c0, c1) in active:
            a[r0:r1, c0:c1] *= factor
        frames[t] = a
    return frames


def pic_series(T: int, n1: int, n2: int, *, stride: int = 500,
               seed: int = 0) -> np.ndarray:
    """The paper's PIC-MAG dumps: ``prefix.pic_like_instance`` every
    ``stride`` iterations (Fig. 4's x-axis)."""
    return np.stack([prefix.pic_like_instance(n1, n2, iteration=t * stride,
                                              seed=seed)
                     for t in range(T)])


def static(T: int, n1: int, n2: int, *, seed: int = 0) -> np.ndarray:
    """One frame repeated T times — the null stream policies must not
    replan on."""
    frame = prefix.pic_like_instance(n1, n2, iteration=0, seed=seed)
    return np.broadcast_to(frame, (T, n1, n2)).copy()


STREAMS = {
    "drifting-hotspot": drifting_hotspot,
    "particle-advection": particle_advection,
    "refinement-bursts": refinement_bursts,
    "pic": pic_series,
    "static": static,
}


# ---------------------------------------------------------------------------
# rank-3 volumes: (T, n1, n2, n3) streams for the d-dimensional planner


def pic_series_3d(T: int, n1: int, n2: int, n3: int, *, stride: int = 500,
                  seed: int = 0) -> np.ndarray:
    """3D PIC dumps: ``prefix.pic_like_instance_3d`` every ``stride``
    iterations — the volumetric analogue of :func:`pic_series` (a drifting
    shell plus a dense lobe, Poisson-sampled, strictly positive)."""
    return np.stack([prefix.pic_like_instance_3d(n1, n2, n3,
                                                 iteration=t * stride,
                                                 seed=seed)
                     for t in range(T)])


def amr_series_3d(T: int, n1: int, n2: int, n3: int, *, levels: int = 3,
                  seed: int = 0) -> np.ndarray:
    """AMR-style 3D refinement hierarchy, re-drawn per frame: nested boxes
    multiply their load by 4x per level, and the boxes move between frames
    (fresh seed each step) — the spatially abrupt regime in 3D."""
    return np.stack([prefix.amr_like_instance_3d(n1, n2, n3, levels=levels,
                                                 seed=seed + t)
                     for t in range(T)])


STREAMS_3D = {
    "pic3d": pic_series_3d,
    "amr3d": amr_series_3d,
}
