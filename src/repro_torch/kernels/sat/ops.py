"""Wrappers of the SAT kernel (``sat.cu``): Gamma of a frame or a stack.

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.  Both take a ``(n1, n2)``
frame or a ``(B, n1, n2)`` stack of int32 or float32 loads.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import gamma_ref

_FN = {torch.float32: "repro_sat_gamma_f32", torch.int32: "repro_sat_gamma_i32"}


def gamma(a: torch.Tensor) -> torch.Tensor:
    """The paper's Gamma array: exclusive prefix, shape (..., n1+1, n2+1),
    in ``a``'s dtype."""
    if a.ndim not in (2, 3):
        raise ValueError(f"gamma takes (n1, n2) or (B, n1, n2), got {a.ndim}D")
    if a.dtype not in _FN:
        raise TypeError(f"gamma takes int32 or float32 loads, got {a.dtype}")
    if _build.on_cpu("sat", a):
        return gamma_ref(a)
    x = a.contiguous()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    B, n1, n2 = x.shape
    if B > 65535:
        raise ValueError(f"sat kernel takes at most 65535 frames, got {B}")
    _build.check_cuda("sat", x)
    g = torch.empty((B, n1 + 1, n2 + 1), dtype=x.dtype, device=x.device)
    _build.launch("sat", _FN[x.dtype], x, g, B, n1, n2)
    return g[0] if squeeze else g


def sat(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum (a view into :func:`gamma`'s result)."""
    return gamma(a)[..., 1:, 1:]
