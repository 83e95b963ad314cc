"""Prefix-sum (summed-area table) utilities and instance generators.

The port's NumPy copy of ``repro.core.prefix``: the same code in the same
order of floating-point operations, so its results are bit-identical.

The paper assumes the load matrix is given as a 2D prefix-sum array Gamma so
any rectangle load is O(1) (Section 2.1). All host-side algorithms in this
package consume Gamma, never A. ``kernels/sat`` builds the same table on-TPU.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Gamma construction


def prefix_sum_2d(a: np.ndarray) -> np.ndarray:
    """Exclusive 2D prefix sum, shape (n1+1, n2+1); Gamma[i,j] = A[:i,:j].sum().

    Integer inputs are accumulated in int64 (exact); floats in float64.
    """
    a = np.asarray(a)
    dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float64
    g = np.zeros((a.shape[0] + 1, a.shape[1] + 1), dtype=dtype)
    np.cumsum(np.cumsum(a, axis=0, dtype=dtype), axis=1, out=g[1:, 1:])
    return g


def rect_load(gamma: np.ndarray, r0: int, r1: int, c0: int, c1: int):
    """Load of half-open rectangle [r0,r1) x [c0,c1) in O(1)."""
    return gamma[r1, c1] - gamma[r0, c1] - gamma[r1, c0] + gamma[r0, c0]


def row_prefix(gamma: np.ndarray) -> np.ndarray:
    """1D prefix array of the projection onto the main (row) dimension."""
    return gamma[:, -1]


def stripe_col_prefix(gamma: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """1D prefix array of columns restricted to rows [r0, r1).

    A key trick from the paper: no re-projection needed, a stripe's column
    prefix array is just a difference of two Gamma rows.
    """
    return gamma[r1, :] - gamma[r0, :]


def col_prefix(gamma: np.ndarray) -> np.ndarray:
    return gamma[-1, :]


def stripe_row_prefix(gamma: np.ndarray, c0: int, c1: int) -> np.ndarray:
    return gamma[:, c1] - gamma[:, c0]


def transpose_gamma(gamma: np.ndarray) -> np.ndarray:
    return gamma.T.copy()


def prefix_sum_3d(a: np.ndarray) -> np.ndarray:
    """Exclusive 3D prefix sum, shape (n1+1, n2+1, n3+1);
    Gamma[i,j,k] = A[:i,:j,:k].sum().  Integer inputs accumulate in int64
    (exact); floats in float64.  One of these serves every slab of the 3D
    partitioners: the 2D Gamma of slab [x0,x1) is ``g[x1] - g[x0]``.
    """
    a = np.asarray(a)
    dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float64
    g = np.zeros((a.shape[0] + 1, a.shape[1] + 1, a.shape[2] + 1), dtype=dtype)
    np.cumsum(np.cumsum(np.cumsum(a, axis=0, dtype=dtype), axis=1), axis=2,
              out=g[1:, 1:, 1:])
    return g


def rect_load_3d(gamma3: np.ndarray, x0: int, x1: int, r0: int, r1: int,
                 c0: int, c1: int):
    """Load of half-open box [x0,x1) x [r0,r1) x [c0,c1) by 3D
    inclusion–exclusion over the eight corners, O(1)."""
    return (gamma3[x1, r1, c1] - gamma3[x0, r1, c1]
            - gamma3[x1, r0, c1] - gamma3[x1, r1, c0]
            + gamma3[x0, r0, c1] + gamma3[x0, r1, c0] + gamma3[x1, r0, c0]
            - gamma3[x0, r0, c0])


# ---------------------------------------------------------------------------
# Instance generators (Section 4.1 of the paper)


def uniform_instance(n1: int, n2: int, delta: float = 1.2,
                     seed: int = 0) -> np.ndarray:
    """Load of each cell uniform in [1000, 1000*delta] (paper's Uniform)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1000, max(int(1000 * delta), 1001),
                        size=(n1, n2)).astype(np.int64)


def _distance_field(n1: int, n2: int, refs: np.ndarray) -> np.ndarray:
    ii, jj = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    pts = np.stack([ii.ravel(), jj.ravel()], axis=1).astype(np.float64)
    d = np.linalg.norm(pts[:, None, :] - refs[None, :, :], axis=2).min(axis=1)
    return d.reshape(n1, n2)


def diagonal_instance(n1: int, n2: int, seed: int = 0) -> np.ndarray:
    """Load ~ U(0, n1*n2) / (dist to closest diagonal point + 0.1)."""
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    # distance of (i, j) to the line i*n2 = j*n1, normalized to cell units
    d = np.abs(ii * n2 - jj * n1) / np.hypot(n1, n2)
    u = rng.uniform(0, n1 * n2, size=(n1, n2))
    return np.maximum(u / (d + 0.1), 0).astype(np.int64)


def peak_instance(n1: int, n2: int, n_peaks: int = 1,
                  seed: int = 0) -> np.ndarray:
    """Load ~ U(0, n1*n2) / (dist to closest of n_peaks random points + 0.1)."""
    rng = np.random.default_rng(seed)
    refs = np.stack([rng.integers(0, n1, n_peaks),
                     rng.integers(0, n2, n_peaks)], axis=1).astype(np.float64)
    d = _distance_field(n1, n2, refs)
    u = rng.uniform(0, n1 * n2, size=(n1, n2))
    return np.maximum(u / (d + 0.1), 0).astype(np.int64)


def multipeak_instance(n1: int, n2: int, seed: int = 0) -> np.ndarray:
    return peak_instance(n1, n2, n_peaks=3, seed=seed)


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


def pic_like_instance_3d(n1: int, n2: int, n3: int, iteration: int = 0,
                         mean_particles_per_cell: float = 200.0,
                         seed: int = 0) -> np.ndarray:
    """3D PIC-like volume: a drifting shell of particle density plus
    background — the rank-3 analogue of :func:`pic_like_instance`, feeding
    the Section-6-style 3D partitioners.  Positive everywhere (like PIC)."""
    rng = np.random.default_rng(seed + iteration)
    t = iteration / 40_000.0
    cx, cy, cz = n1 * (0.45 + 0.1 * t), n2 * 0.5, n3 * 0.5
    ii, jj, kk = np.meshgrid(np.arange(n1), np.arange(n2), np.arange(n3),
                             indexing="ij")
    r = np.sqrt((ii - cx) ** 2 + (jj - cy) ** 2 + (kk - cz) ** 2)
    shell = np.exp(-((r - n1 * 0.25) ** 2)
                   / (2 * (n1 * (0.06 + 0.02 * t)) ** 2))
    lobe = np.exp(-(((ii - cx * 1.2) ** 2) / (2 * (n1 * 0.3) ** 2)
                    + ((jj - cy) ** 2) / (2 * (n2 * 0.2) ** 2)
                    + ((kk - cz) ** 2) / (2 * (n3 * 0.2) ** 2)))
    dens = 1.0 + (0.3 + 0.1 * np.sin(8 * t)) * shell + 0.15 * lobe
    dens = dens / dens.mean() * mean_particles_per_cell
    return rng.poisson(dens).astype(np.int64) + 1


def amr_like_instance_3d(n1: int, n2: int, n3: int, levels: int = 3,
                         seed: int = 0) -> np.ndarray:
    """AMR-like volume: nested refinement boxes multiply the cell cost by
    4x per level inside shrinking random sub-boxes — sharp load cliffs,
    the case where uniform grids lose badly."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 4, size=(n1, n2, n3)).astype(np.int64)
    lo = np.zeros(3, dtype=np.int64)
    hi = np.array([n1, n2, n3], dtype=np.int64)
    for _ in range(levels):
        span = hi - lo
        if (span < 4).any():
            break
        lo = lo + rng.integers(0, np.maximum(span // 3, 1), size=3)
        hi = hi - rng.integers(0, np.maximum(span // 3, 1), size=3)
        lo, hi = np.minimum(lo, hi - 2), np.maximum(hi, lo + 2)
        a[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] *= 4
    return a


def mesh_like_instance(n1: int, n2: int, n_vertices: int = 60_000,
                       seed: int = 0) -> np.ndarray:
    """SLAC-like: vertices of a 3D surface mesh projected to a 2D grid.

    Sparse (many zero cells), unit load per vertex — the case that defeats
    most jagged algorithms in the paper (Figure 12) and where hierarchical
    methods shine.
    """
    rng = np.random.default_rng(seed)
    # sample points on a torus-ish cavity surface and project (x, y)
    u = rng.uniform(0, 2 * np.pi, n_vertices)
    v = rng.uniform(0, 2 * np.pi, n_vertices)
    big, small = 0.36, 0.14
    x = (big + small * np.cos(v)) * np.cos(u) * 0.5 + 0.5
    y = (big + small * np.cos(v)) * np.sin(u) * 0.16 + 0.5  # flattened cavity
    a = np.zeros((n1, n2), dtype=np.int64)
    np.add.at(a, (np.clip((x * n1).astype(int), 0, n1 - 1),
                  np.clip((y * n2).astype(int), 0, n2 - 1)), 1)
    return a


INSTANCES = {
    "uniform": uniform_instance,
    "diagonal": diagonal_instance,
    "peak": peak_instance,
    "multipeak": multipeak_instance,
    "pic": pic_like_instance,
    "slac": mesh_like_instance,
}

# (n1, n2, n3, **kw) -> (n1, n2, n3) int64 volume
INSTANCES_3D = {
    "pic3d": pic_like_instance_3d,
    "amr3d": amr_like_instance_3d,
}
