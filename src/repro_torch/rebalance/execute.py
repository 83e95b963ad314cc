"""Executed migrations: actually move owned state, and price plans on the card.

The port of ``repro.rebalance.execute``.  ``migrate`` prices a plan switch
on paper (owner-map diff, weight sums); this module *performs* it and
reports what was measured, so the runtime's cost model can be audited
against real transfers.  The contract — tested on integer streams, where
every sum is exact — is::

    receipt.executed_bytes == migrate.migration_volume(old, new, weights)
    receipt.pair_bytes     == migrate.migration_matrix(old, new, weights)

Execution model: one card.  For every (src, dst) processor pair with a
non-empty owner-change flow, the moved cells' weights are copied host ->
card -> host with explicit ``tensor.to`` copies and a synchronize, and
``executed_bytes`` sums the buffers *after* the transfer — the measurement
comes from the data that actually arrived, not from the plan diff.
Integer frames travel as ``int32`` (exact sums); anything else as
``float32``.

Per-rectangle accounting rides the rectload kernel (K3) with its leading
frame axis: one batched launch over the stack ``[Gamma(weights),
Gamma(retained weights)]`` under the *adopted* plan's cuts prices every
rectangle's total and retained load on the card, and their difference is
the weight each rectangle received (``receipt.rect_received``,
cross-checked against the measured pair inflows).  Gammas are float32 on
the card — exact for integer totals below 2**24, the same envelope as the
batched planner.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prefix
from repro_torch.kernels.rectload.ops import jagged_loads
from repro_torch.obs import trace as _trace

from . import migrate
from .batch_device import Plan
from .planner import resolve_device

__all__ = ["MigrationReceipt", "execute_migration", "plan_rect_loads",
           "verify_receipt"]


@dataclasses.dataclass(frozen=True)
class MigrationReceipt:
    """What an executed plan switch actually moved.

    ``executed_bytes`` is weight measured from the transferred buffers
    (the unit is weight, like ``migration_volume`` — "bytes" names the
    role: it is the wire-transfer ledger entry, proportional to bytes
    for fixed-size per-unit state).
    """

    executed_bytes: float       # total measured weight moved
    pair_bytes: np.ndarray      # (m, m) measured per (src, dst) flow
    n_transfers: int            # (src, dst) payloads moved
    rect_loads: np.ndarray      # (m,) adopted-plan loads (rectload kernel)
    rect_received: np.ndarray   # (m,) weight each rectangle received
    device_of: np.ndarray       # (m,) device index per processor


def _weight_array(plan: Plan, weights) -> tuple[np.ndarray, np.dtype]:
    """Per-cell weights as (n1, n2) + the on-wire dtype (int32 when the
    frame is integral so the measured sums are exact)."""
    if weights is None:
        w = np.ones(plan.shape, dtype=np.int64)
    else:
        w = np.asarray(weights)
        if w.shape != plan.shape:
            raise ValueError(f"weights shape {w.shape} != grid "
                             f"{plan.shape}")
    integral = np.issubdtype(w.dtype, np.integer)
    return w, (np.int32 if integral else np.float32)


def _plan_cuts(plan: Plan) -> tuple[np.ndarray, np.ndarray]:
    """(row_cuts, live col_cuts) as int32, checked against the grid: the
    kernel reads Gamma at every cut, so an out-of-range cut is refused
    here rather than read."""
    n1, n2 = plan.shape
    rc = np.asarray(plan.row_cuts)
    cc = plan._live_col_cuts()
    if rc.min(initial=0) < 0 or rc.max(initial=0) > n1 \
            or cc.min(initial=0) < 0 or cc.max(initial=0) > n2:
        raise ValueError(f"plan cuts fall outside the {plan.shape} grid")
    return rc.astype(np.int32), cc.astype(np.int32)


def _live_loads(plan: Plan, loads_pq: np.ndarray) -> np.ndarray:
    """Flatten a (P, m_max) rectload result to the (m,) row-major live
    vector (masked trailing intervals dropped)."""
    live = np.arange(1, plan.col_cuts.shape[1])[None, :] \
        <= np.asarray(plan.counts)[:, None]
    return loads_pq[live]


def plan_rect_loads(plan: Plan, weights=None, *, device=None) -> np.ndarray:
    """(m,) per-rectangle loads of ``plan`` computed on ``device`` (the
    card by default) via the rectload kernel (host twin: :meth:`Plan.loads`
    on the frame's Gamma)."""
    dev = resolve_device(device)
    w, _ = _weight_array(plan, weights)
    rc, cc = _plan_cuts(plan)
    g = torch.from_numpy(prefix.prefix_sum_2d(w).astype(np.float32)).to(dev)
    out = jagged_loads(g, torch.from_numpy(rc).to(dev),
                       torch.from_numpy(cc).to(dev))
    return _live_loads(plan, out.cpu().numpy())


def execute_migration(old: Plan, new: Plan, weights=None, *,
                      device=None) -> MigrationReceipt:
    """Move every owner-changed cell's weight through ``device`` (the card
    by default) and measure what arrived.  See the module docstring for
    the exactness contract against :mod:`repro_torch.rebalance.migrate`.
    """
    dev = resolve_device(device)
    w, wire_dtype = _weight_array(old, weights)
    m = max(old.m, new.m)
    device_of = np.zeros(m, dtype=np.int64)

    o = old.owner_map().ravel()
    n = new.owner_map().ravel()
    wf = w.ravel()
    moved = o != n

    pair_bytes = np.zeros((m, m))
    executed = 0.0
    n_transfers = 0
    with _trace.span("rebalance.execute", m=m, device=str(dev),
                     moved_cells=int(moved.sum())) as sp:
        if moved.any():
            src, dst, vals = o[moved], n[moved], wf[moved]
            # group moved cells by (src, dst) pair: one transfer per pair
            key = src.astype(np.int64) * m + dst
            order = np.argsort(key, kind="stable")
            key, vals = key[order], vals[order]
            starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            bounds = np.r_[starts, key.size]
            for a, b in zip(bounds[:-1], bounds[1:]):
                i, j = divmod(int(key[a]), m)
                payload = torch.from_numpy(
                    np.ascontiguousarray(vals[a:b], dtype=wire_dtype)).to(dev)
                received = payload.to("cpu")
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                got = float(received.numpy().sum(dtype=np.float64))
                pair_bytes[i, j] += got
                executed += got
                n_transfers += 1
        sp.args["executed"] = executed

        # per-rectangle receipt: one batched rectload launch prices the
        # adopted plan on [full weights, retained weights] — their
        # difference is what each rectangle received
        g_full = prefix.prefix_sum_2d(w)
        g_kept = prefix.prefix_sum_2d(
            np.where((o == n).reshape(w.shape), w, 0))
        stack = torch.from_numpy(
            np.stack([g_full, g_kept]).astype(np.float32)).to(dev)
        rc, cc = _plan_cuts(new)
        rc2 = torch.from_numpy(np.stack([rc, rc])).to(dev)
        cc2 = torch.from_numpy(np.stack([cc, cc])).to(dev)
        both = jagged_loads(stack, rc2, cc2).cpu().numpy()
        rect_loads = _live_loads(new, both[0])
        rect_received = _live_loads(new, both[0] - both[1])

    return MigrationReceipt(executed_bytes=executed, pair_bytes=pair_bytes,
                            n_transfers=n_transfers, rect_loads=rect_loads,
                            rect_received=rect_received,
                            device_of=device_of)


def verify_receipt(old: Plan, new: Plan, weights=None, *,
                   receipt: MigrationReceipt, rtol: float = 0.0,
                   atol: float = 0.0) -> None:
    """Assert the measured receipt matches the paper ledger (exact by
    default — the integer-stream contract; pass tolerances for float
    frames).  Raises ``AssertionError`` with the deltas on mismatch."""
    vol = migrate.migration_volume(old, new, weights)
    if not np.isclose(receipt.executed_bytes, vol, rtol=rtol, atol=atol):
        raise AssertionError(f"executed_bytes {receipt.executed_bytes} != "
                             f"migration_volume {vol}")
    flow = migrate.migration_matrix(old, new, weights)
    if not np.allclose(receipt.pair_bytes, flow, rtol=rtol, atol=atol):
        delta = float(np.abs(receipt.pair_bytes - flow).max())
        raise AssertionError(f"pair_bytes != migration_matrix "
                             f"(max delta {delta})")
    inflow = receipt.pair_bytes.sum(axis=0)
    if not np.allclose(receipt.rect_received[:inflow.size], inflow,
                       rtol=max(rtol, 1e-6), atol=max(atol, 1e-4)):
        raise AssertionError("rect_received disagrees with measured pair "
                             "inflows")
