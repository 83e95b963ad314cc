"""Wrapper of the probe kernel (``probe.cu``).

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import probe_counts_ref

_FN = {torch.float32: "repro_probe_counts_f32",
       torch.int32: "repro_probe_counts_i32"}
# the largest dynamic shared memory a block can take on Hopper
_SMEM_MAX = 232448


def probe_counts(p: torch.Tensor, Ls: torch.Tensor, cap: int) -> torch.Tensor:
    """Greedy interval counts per (row, candidate): (S, N+1) x (S, K)
    -> (S, K) int32, ``cap + 1`` marking infeasible rows.  See
    ``ref.probe_counts_ref`` for the exact semantics contract.  int32
    rows need a total load below 2**30 (``p[pos] + L`` must not wrap).
    """
    if p.ndim != 2 or Ls.ndim != 2 or Ls.shape[0] != p.shape[0]:
        raise ValueError(f"probe_counts takes p (S, N+1) and Ls (S, K), got "
                         f"{tuple(p.shape)} and {tuple(Ls.shape)}")
    if p.dtype not in _FN or Ls.dtype != p.dtype:
        raise TypeError(f"probe_counts takes int32 or float32 p and Ls of "
                        f"one dtype, got {p.dtype} and {Ls.dtype}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if _build.on_cpu("probe", p):
        return probe_counts_ref(p, Ls, cap)
    p, Ls = p.contiguous(), Ls.contiguous()
    _build.check_cuda("probe", p, Ls)
    S, n_plus_1 = p.shape
    if n_plus_1 * p.element_size() > _SMEM_MAX:
        raise ValueError(f"probe kernel stages a row in shared memory: "
                         f"{n_plus_1} entries do not fit")
    out = torch.empty(Ls.shape, dtype=torch.int32, device=p.device)
    _build.launch("probe", _FN[p.dtype], p, Ls, out, S, n_plus_1,
                  Ls.shape[1], cap)
    return out
