"""Plan diffing: what does switching rectangle covers actually cost?

Repartitioning is only free on paper.  In a running simulation every cell
that changes owner drags its state (particles, field values, KV blocks)
across the network, so the relevant price of a new plan is the *migration
volume* — the total weight of cells whose owner differs between the old
and new covers (Tzovas-Predari's dominant knob).  Processor identity is
the positional rectangle index along the row-major sweep (see
``batch_device.Plan``), so two near-identical jagged covers diff to a
near-zero volume rather than a spurious full reshuffle.

The port's NumPy copy of ``repro.rebalance.migrate``.
"""
from __future__ import annotations

import numpy as np

from .batch_device import Plan

__all__ = ["migration_volume", "migration_matrix", "per_processor_churn"]


def _weights(plan: Plan, weights) -> np.ndarray | None:
    if weights is None:
        return None
    w = np.asarray(weights)
    if w.shape != plan.shape:
        raise ValueError(f"weights shape {w.shape} != grid {plan.shape}")
    return w


def migration_volume(old: Plan, new: Plan, weights=None) -> float:
    """Total weight on cells whose owner changes from ``old`` to ``new``.

    ``weights`` is an (n1, n2) per-cell cost (typically the current load
    frame); ``None`` counts cells.  Symmetric in its plan arguments and 0
    iff the owner maps agree everywhere.
    """
    moved = old.owner_map() != new.owner_map()
    w = _weights(old, weights)
    return float(moved.sum() if w is None else w[moved].sum())


def migration_matrix(old: Plan, new: Plan, weights=None) -> np.ndarray:
    """(m, m) flow matrix: entry [i, j] is the weight leaving processor i
    for processor j (diagonal is zero — retained cells don't move)."""
    o = old.owner_map().ravel()
    n = new.owner_map().ravel()
    m = max(old.m, new.m)
    w = _weights(old, weights)
    wf = None if w is None else w.ravel().astype(np.float64)
    moved = o != n
    flow = np.zeros((m, m))
    np.add.at(flow, (o[moved], n[moved]),
              1.0 if wf is None else wf[moved])
    return flow


def per_processor_churn(old: Plan | None = None, new: Plan | None = None,
                        weights=None, *, flow: np.ndarray | None = None
                        ) -> dict:
    """Per-processor outflow/inflow (and their max — the migration
    straggler, since migration finishes when the busiest link drains).

    Pass a precomputed ``flow`` (from :func:`migration_matrix`) to avoid
    recomputing the owner-map diff when the caller already holds it.
    """
    if flow is None:
        flow = migration_matrix(old, new, weights)
    out = flow.sum(axis=1)
    inn = flow.sum(axis=0)
    return {"outflow": out, "inflow": inn,
            "max_link": float(np.maximum(out, inn).max(initial=0.0)),
            "volume": float(flow.sum())}
