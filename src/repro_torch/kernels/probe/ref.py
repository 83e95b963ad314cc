"""Plain PyTorch version of the probe-counts kernel (and its contract).

``probe_counts_ref(p, Ls, cap)`` is ``repro.kernels.probe.ref``'s oracle:

- each greedy step extends to the furthest index with load <= L;
- a row that cannot advance (single element > L) or needs more than
  ``cap`` intervals reports ``cap + 1`` (the infeasibility sentinel);
- an empty row (total load 0 over zero elements) still counts 1.

Feasibility for an m-way solve is therefore ``counts <= m`` with
``cap = m``.
"""
from __future__ import annotations

import torch


def probe_counts_ref(p: torch.Tensor, Ls: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """Greedy interval counts. p: (S, N+1) prefixes, Ls: (S, K) -> (S, K)
    int32."""
    n = p.shape[-1] - 1
    pos = torch.zeros(Ls.shape, dtype=torch.int64, device=p.device)
    cnt = torch.zeros(Ls.shape, dtype=torch.int32, device=p.device)
    for _ in range(cap):
        target = p.gather(-1, pos) + Ls
        nxt = torch.searchsorted(p, target, right=True) - 1
        nxt = torch.maximum(nxt, pos).clamp_max(n)
        adv = (pos < n) & (nxt > pos)
        pos = torch.where(adv, nxt, pos)
        cnt += adv
    return torch.where(pos < n, cap + 1, cnt.clamp_min(1)).to(torch.int32)
