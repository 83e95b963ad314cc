"""Rectilinear (P x Q general block) partitions — paper Section 3.1.

The port's NumPy copy of ``repro.core.rect``: the same code in the same
order of floating-point operations, so its results are bit-identical.

- RECT-UNIFORM: the MPI_Cart-style naive split balancing *area* not load.
- RECT-NICOL:   Nicol's iterative refinement — alternately fix one
  dimension's cuts and compute the optimal cuts of the other, where the
  "load" of a column interval is the max over row stripes (and vice versa).
  Interval loads are monotone by inclusion, so the probe machinery applies;
  the inner optimum runs on the shared wide-bisection engine with the
  packed "max across stripes" probe (``PackedPrefixes.joint_counts``).
"""
from __future__ import annotations

import numpy as np

from . import search
from .stripecache import stripe_matrix
from .types import Partition, from_grid


def rect_uniform(gamma: np.ndarray, m: int, P: int | None = None,
                 Q: int | None = None) -> Partition:
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    if P is None or Q is None:
        P = Q = int(round(np.sqrt(m)))
        if P * Q != m:
            raise ValueError(f"m={m} is not square; pass P and Q explicitly")
    row_cuts = np.linspace(0, n1, P + 1).round().astype(np.int64)
    col_cuts = np.linspace(0, n2, Q + 1).round().astype(np.int64)
    return from_grid(row_cuts, col_cuts, (n1, n2))


def _stripe_prefixes(gamma: np.ndarray, cuts: np.ndarray,
                     axis: int) -> np.ndarray:
    """(P, n+1) prefix arrays of each stripe along the *other* axis."""
    cuts = np.asarray(cuts)
    if axis == 0:  # stripes are row intervals; arrays run over columns
        return stripe_matrix(gamma, cuts[:-1], cuts[1:])
    return stripe_matrix(gamma.T, cuts[:-1], cuts[1:])


def _probe_max(ps: np.ndarray, k: int, L: float) -> np.ndarray | None:
    """Probe for the 'max across stripes' interval-load structure.

    ps: (P, n+1) stripe prefix arrays. Feasible cut e from b is the largest
    e such that every stripe's interval load <= L, i.e. the min over stripes
    of each stripe's own largest feasible e.  (Kept as the scalar cut
    realizer; feasibility during bisection runs through the packed probe.)
    """
    P, n1 = ps.shape
    n = n1 - 1
    cuts = np.empty(k + 1, dtype=np.int64)
    cuts[0] = 0
    b = 0
    for i in range(1, k + 1):
        if ((ps[:, n] - ps[:, b]) <= L).all():
            cuts[i:] = [b] * (k - i) + [n]
            return cuts
        e = n
        for s in range(P):
            es = int(np.searchsorted(ps[s], ps[s, b] + L, side="right")) - 1
            if es < e:
                e = es
        if e <= b:
            return None
        cuts[i] = e
        b = e
    return None


def _optimal_cuts_given_fixed(gamma: np.ndarray, fixed_cuts: np.ndarray,
                              fixed_axis: int, k: int) -> np.ndarray:
    """Optimal 1D cuts of the free axis for the max-over-stripes load."""
    ps = _stripe_prefixes(gamma, fixed_cuts, fixed_axis)
    total_max = float((ps[:, -1] - ps[:, 0]).max(initial=0))
    # element upper bound: max over stripes of largest single element
    el = float((ps[:, 1:] - ps[:, :-1]).max(initial=0))
    lo, hi = max(total_max / k, el), total_max
    integral = np.issubdtype(ps.dtype, np.integer)
    packed = search.PackedPrefixes(ps)
    L = search.bisect_bottleneck(
        lambda Ls: packed.joint_counts(Ls, k) <= k, lo, hi,
        integral=integral)
    return search.realize(lambda Lc: _probe_max(ps, k, Lc), L,
                          integral=integral)


def rect_nicol(gamma: np.ndarray, m: int, P: int | None = None,
               Q: int | None = None, max_iters: int = 50) -> Partition:
    """Iterative refinement (Nicol '94 / Manne-Sorevik '96)."""
    n1, n2 = gamma.shape[0] - 1, gamma.shape[1] - 1
    if P is None or Q is None:
        P = Q = int(round(np.sqrt(m)))
        if P * Q != m:
            raise ValueError(f"m={m} is not square; pass P and Q explicitly")
    # start from the uniform grid in the row dimension
    row_cuts = np.linspace(0, n1, P + 1).round().astype(np.int64)
    col_cuts = None
    prev = None
    for _ in range(max_iters):
        col_cuts = _optimal_cuts_given_fixed(gamma, row_cuts, 0, Q)
        row_cuts = _optimal_cuts_given_fixed(gamma, col_cuts, 1, P)
        key = (row_cuts.tobytes(), col_cuts.tobytes())
        if key == prev:
            break
        prev = key
    return from_grid(row_cuts, col_cuts, (n1, n2))
