"""Batched on-device partitioning for time-stepped load frames.

The port of ``repro.rebalance.batch_device``.  The whole chain — SAT
build (kernel K1) followed by the partitioner — runs over a
``(T, n1, n2)`` batch of load frames on the card, so the load matrices
and their prefix tables never leave device memory and only the O(m) cut
vectors per frame come back to the host.  The batch axis is a tensor
axis, never a Python loop over frames.

The pipeline itself lives in ``repro_torch.rebalance.planner`` as
composable stages; this module holds the standalone entry points plus
the host-side ``Plan`` view: numpy cut vectors and the derived owner map
and per-rectangle loads the rebalancing runtime needs.  Entry points take
``device=None``, which means the card (see ``planner.resolve_device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.rebalance import planner

__all__ = ["Plan", "gamma_batch", "jag_m_heur_batch", "plan_stream",
           "unstack_plans"]


def gamma_batch(frames, *, gamma_dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Gamma for every frame: (T, n1, n2) loads -> (T, n1+1, n2+1) prefixes.

    The standalone form of the planner's ingest + SAT stages.  Frames are
    cast to ``gamma_dtype`` *before* the scan so accumulation happens in
    that dtype (f32 is exact only below 2**24 total load).
    """
    dev = planner.resolve_device(device)
    return planner.sat_stage(planner.ingest_stage(
        planner._to_device(frames, dev), gamma_dtype=gamma_dtype))


def jag_m_heur_batch(gammas, *, P: int, m: int, k: int = 8,
                     rounds: int = 8, gamma_dtype=None, device=None):
    """JAG-M-HEUR over a (T, n1+1, n2+1) Gamma batch.

    The standalone form of the planner's partition stage.  Returns
    (row_cuts (T, P+1), counts (T, P), col_cuts (T, P, m_max+1),
    Lmax (T,)).
    """
    dev = planner.resolve_device(device)
    return planner.partition_stage(planner._to_device(gammas, dev), P=P,
                                   m=m, k=k, rounds=rounds,
                                   gamma_dtype=gamma_dtype)


def plan_stream(frames, *, P: int, m: int, k: int = 8, rounds: int = 8,
                gamma_dtype=None, exact: bool = False, device=None):
    """SAT + partitioner for a whole (T, n1, n2) stream on one device.

    Every intermediate (frames, Gammas) stays on the device; the returned
    tensors are the O(T * m) cut vectors only.  ``exact=True`` swaps in
    the exact JAG-PQ-OPT (needs ``m % P == 0``).  The same chain as
    ``planner.plan_stream(mesh=None)``.
    """
    return planner.plan_stream(frames, P=P, m=m, k=k, rounds=rounds,
                               gamma_dtype=gamma_dtype, exact=exact,
                               device=device)


# ---------------------------------------------------------------------------
# host-side view


@dataclasses.dataclass(frozen=True)
class Plan:
    """One frame's jagged partition as host numpy cut vectors.

    Processor identity is positional: global index ``sum(counts[:s]) + t``
    for interval ``t`` of stripe ``s`` — consecutive plans number their
    rectangles along the same row-major sweep, which is what makes plan
    diffs (``migrate``) meaningful.
    """

    row_cuts: np.ndarray          # (P+1,) int
    counts: np.ndarray            # (P,) int, sums to m
    col_cuts: np.ndarray          # (P, m_max+1) int, masked past counts[s]
    shape: tuple[int, int]

    @property
    def m(self) -> int:
        return int(self.counts.sum())

    def stripe_col_cuts(self, s: int) -> np.ndarray:
        """The live cut array of stripe ``s`` (length counts[s] + 1)."""
        return self.col_cuts[s, :int(self.counts[s]) + 1]

    def _live_col_cuts(self) -> np.ndarray:
        """(P, m_max+1) cuts with masked entries pinned at n2, so vectorized
        searches see each stripe as monotone with empty trailing intervals."""
        idx = np.arange(self.col_cuts.shape[1])
        live = idx[None, :] <= np.asarray(self.counts)[:, None]
        return np.where(live, self.col_cuts, self.shape[1])

    def owner_map(self) -> np.ndarray:
        """(n1, n2) int32 map: cell -> global processor index.

        Fully vectorized (no per-stripe Python loop) and memoized — the
        runtime diffs owner maps every step, and consecutive diffs reuse
        both sides.  Matches the per-stripe ``np.repeat`` construction
        bit-for-bit (property-tested).
        """
        cached = self.__dict__.get("_owner_map")
        if cached is not None:
            return cached
        counts = np.asarray(self.counts, dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(counts[:-1])])
        cc = self._live_col_cuts()
        cols = np.arange(self.shape[1])
        # interval of column j in stripe s = #cuts (past the leading 0) <= j
        col_owner = (cc[:, 1:, None] <= cols[None, None, :]).sum(axis=1)
        stripe_of_row = np.repeat(np.arange(len(counts)),
                                  np.diff(self.row_cuts))
        own = (base[:, None] + col_owner).astype(np.int32)[stripe_of_row]
        object.__setattr__(self, "_owner_map", own)
        return own

    def loads(self, gamma: np.ndarray) -> np.ndarray:
        """(m,) per-processor loads on an arbitrary frame's host Gamma.

        Vectorized: one fancy-indexed gather over all stripes at once;
        masked intervals (pinned at n2) difference to zero and are
        dropped, preserving the row-major positional order.
        """
        g = np.asarray(gamma)
        cc = self._live_col_cuts()
        r0 = np.asarray(self.row_cuts[:-1], dtype=np.intp)[:, None]
        r1 = np.asarray(self.row_cuts[1:], dtype=np.intp)[:, None]
        band = g[r1, cc] - g[r0, cc]              # (P, m_max+1)
        seg = np.diff(band, axis=1)               # (P, m_max)
        live = np.arange(1, cc.shape[1])[None, :] \
            <= np.asarray(self.counts)[:, None]
        return seg[live]

    def max_load(self, gamma: np.ndarray) -> float:
        return float(self.loads(gamma).max(initial=0))

    def to_partition(self):
        """Convert to a ``core.types.Partition`` (validation, plotting)."""
        from repro_torch.core import types
        return types.from_row_cuts_and_col_cuts(
            self.row_cuts, [self.stripe_col_cuts(s)
                            for s in range(len(self.counts))], self.shape)

    def validate(self, gamma: np.ndarray | None = None, *,
                 m: int | None = None) -> "Plan":
        """Structural check: raise ``ValueError`` on any malformed plan.

        Verifies the cut vectors describe a disjoint cover of the grid —
        row cuts span ``[0, n1]`` monotonically, every stripe has >= 1
        interval whose cuts span ``[0, n2]`` monotonically — plus, when
        given, ``m`` (rectangle count) and ``gamma`` (per-rectangle loads
        sum to the frame's total: nothing dropped, nothing double-counted).
        All problems are collected into one message.  Returns ``self`` so
        call sites can chain.
        """
        problems: list[str] = []
        n1, n2 = self.shape
        rc = np.asarray(self.row_cuts)
        ct = np.asarray(self.counts)
        if rc.ndim != 1 or rc.size != ct.size + 1:
            problems.append(f"row_cuts shape {rc.shape} does not match "
                            f"{ct.size} stripes")
        else:
            if rc[0] != 0 or rc[-1] != n1:
                problems.append(f"row cuts span [{rc[0]}, {rc[-1]}], "
                                f"expected [0, {n1}]")
            if (np.diff(rc) < 0).any():
                problems.append(f"row cuts not monotone: {rc.tolist()}")
        if (ct < 1).any():
            problems.append(f"every stripe needs >= 1 interval, "
                            f"counts={ct.tolist()}")
        elif self.col_cuts.shape[0] != ct.size \
                or self.col_cuts.shape[1] < int(ct.max(initial=0)) + 1:
            problems.append(f"col_cuts shape {self.col_cuts.shape} too "
                            f"small for counts {ct.tolist()}")
        else:
            for s in range(ct.size):
                cc = self.stripe_col_cuts(s)
                if cc[0] != 0 or cc[-1] != n2:
                    problems.append(f"stripe {s} col cuts span "
                                    f"[{cc[0]}, {cc[-1]}], "
                                    f"expected [0, {n2}]")
                if (np.diff(cc) < 0).any():
                    problems.append(f"stripe {s} col cuts not monotone: "
                                    f"{cc.tolist()}")
        if m is not None and not problems and self.m != m:
            problems.append(f"plan has {self.m} rectangles, expected {m}")
        if gamma is not None and not problems:
            ga = np.asarray(gamma)
            if ga.shape != (n1 + 1, n2 + 1):
                problems.append(f"gamma shape {ga.shape} does not match "
                                f"the plan's {(n1 + 1, n2 + 1)} prefix "
                                f"table")
            else:
                total = float(ga[-1, -1])
                got = float(self.loads(ga).sum())
                if not np.isclose(got, total, rtol=1e-9, atol=1e-6):
                    problems.append(f"rectangle loads sum to {got}, frame "
                                    f"total is {total} (lost or "
                                    f"double-counted cells)")
        if problems:
            raise ValueError("invalid Plan: " + "; ".join(problems))
        return self


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def unstack_plans(batched, shape: tuple[int, int]) -> list[Plan]:
    """Split a ``plan_stream``/``jag_m_heur_batch`` result into T Plans.

    One device-to-host copy per array for the whole batch (the planner's
    cut collect); the per-frame step is pure zero-copy numpy slicing.
    """
    row_cuts, counts, col_cuts, _ = batched
    rc = _host(row_cuts)
    ct = _host(counts)
    cc = _host(col_cuts)
    return [Plan(rc[t], ct[t], cc[t], shape) for t in range(rc.shape[0])]
