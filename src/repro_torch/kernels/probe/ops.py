"""Wrapper of the probe kernel (``probe.cu``).

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.  On the card the row
length chooses the kernel's route (:func:`route`): rows that fit shared
memory are staged there, longer ones are read from global memory.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import probe_counts_ref

_FN = {("probe", torch.float32): "repro_probe_counts_f32",
       ("probe", torch.int32): "repro_probe_counts_i32",
       ("probe_general", torch.float32): "repro_probe_general_f32",
       ("probe_general", torch.int32): "repro_probe_general_i32"}
# the largest dynamic shared memory a block can take on Hopper
_SMEM_MAX = 232448


def route(n_plus_1: int) -> str:
    """The kernel route for prefix rows of ``n_plus_1`` 4-byte entries:
    ``probe`` stages each row in shared memory, ``probe_general`` (rows
    past :data:`_SMEM_MAX` bytes) reads it from global memory."""
    return "probe" if n_plus_1 * 4 <= _SMEM_MAX else "probe_general"


def probe_counts(p: torch.Tensor, Ls: torch.Tensor, cap: int) -> torch.Tensor:
    """Greedy interval counts per (row, candidate): (S, N+1) x (S, K)
    -> (S, K) int32, ``cap + 1`` marking infeasible rows.  See
    ``ref.probe_counts_ref`` for the exact semantics contract.  int32
    rows need a total load below 2**30 (``p[pos] + L`` must not wrap).
    """
    if p.ndim != 2 or Ls.ndim != 2 or Ls.shape[0] != p.shape[0]:
        raise ValueError(f"probe_counts takes p (S, N+1) and Ls (S, K), got "
                         f"{tuple(p.shape)} and {tuple(Ls.shape)}")
    if p.dtype not in (torch.float32, torch.int32) or Ls.dtype != p.dtype:
        raise TypeError(f"probe_counts takes int32 or float32 p and Ls of "
                        f"one dtype, got {p.dtype} and {Ls.dtype}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    if _build.on_cpu("probe", p):
        return probe_counts_ref(p, Ls, cap)
    p, Ls = p.contiguous(), Ls.contiguous()
    _build.check_cuda("probe", p, Ls)
    return _launch(p, Ls, cap, route(p.shape[1]))


def _launch(p: torch.Tensor, Ls: torch.Tensor, cap: int,
            key: str) -> torch.Tensor:
    """Launch route ``key`` of the kernel on checked CUDA tensors (the
    card tests also drive ``probe_general`` on rows that would fit)."""
    S, n_plus_1 = p.shape
    out = torch.empty(Ls.shape, dtype=torch.int32, device=p.device)
    _build.launch(key, _FN[key, p.dtype], p, Ls, out, S, n_plus_1,
                  Ls.shape[1], cap)
    return out
