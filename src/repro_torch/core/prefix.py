"""Prefix sums (the paper's Gamma) and the PIC-MAG-like instance generator.

The port's NumPy copy of the 2D part of ``repro.core.prefix`` that the
frame planner needs: the host Gamma every plan is validated and priced
against, and the generator behind ``rebalance.stream.pic_series``.
"""
from __future__ import annotations

import numpy as np


def prefix_sum_2d(a: np.ndarray) -> np.ndarray:
    """Exclusive 2D prefix sum, shape (n1+1, n2+1); Gamma[i,j] = A[:i,:j].sum().

    Integer inputs are accumulated in int64 (exact); floats in float64.
    """
    a = np.asarray(a)
    dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float64
    g = np.zeros((a.shape[0] + 1, a.shape[1] + 1), dtype=dtype)
    np.cumsum(np.cumsum(a, axis=0, dtype=dtype), axis=1, out=g[1:, 1:])
    return g


def pic_like_instance(n1: int, n2: int, iteration: int = 0,
                      mean_particles_per_cell: float = 2000.0,
                      seed: int = 0) -> np.ndarray:
    """PIC-MAG-like: particles in a magnetosphere-ish density drifting in time.

    A bow-shock-like crescent of particle density plus solar-wind background;
    ``iteration`` shifts the crescent so successive instances mimic the
    paper's every-500-iterations dumps. High per-cell counts keep Delta in
    the paper's observed 1.2-1.5 band (their matrices are near-uniform).
    """
    rng = np.random.default_rng(seed + iteration)
    t = iteration / 40_000.0
    cx, cy = n1 * (0.45 + 0.1 * t), n2 * 0.5
    ii, jj = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    r = np.hypot(ii - cx, jj - cy)
    ring = np.exp(-((r - n1 * 0.22) ** 2) / (2 * (n1 * (0.05 + 0.02 * t)) ** 2))
    lobe = np.exp(-(((ii - cx * 1.3) ** 2) / (2 * (n1 * 0.3) ** 2)
                    + ((jj - cy) ** 2) / (2 * (n2 * 0.18) ** 2)))
    dens = 1.0 + (0.25 + 0.1 * np.sin(8 * t)) * ring + 0.12 * lobe
    dens = dens / dens.mean() * mean_particles_per_cell
    return rng.poisson(dens).astype(np.int64) + 1  # no zeros, like PIC-MAG
