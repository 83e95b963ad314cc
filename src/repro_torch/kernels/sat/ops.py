"""Wrappers of the SAT kernels: Gamma of a 2D frame or stack (K1,
``sat.cu``) and of a 3D volume or stack (K4, ``sat3d.cu``).

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.  :func:`gamma` takes a
``(n1, n2)`` frame or a ``(B, n1, n2)`` stack, :func:`gamma3` a
``(n1, n2, n3)`` volume or a ``(B, n1, n2, n3)`` stack (separate names,
because a rank-3 input is either), of int32 or float32 loads.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import gamma3_ref, gamma_ref

_FN = {torch.float32: "repro_sat_gamma_f32", torch.int32: "repro_sat_gamma_i32"}
_FN3 = {torch.float32: "repro_sat3_gamma_f32",
        torch.int32: "repro_sat3_gamma_i32"}


def _check_dtype(name: str, a: torch.Tensor) -> None:
    if a.dtype not in _FN:
        raise TypeError(f"{name} takes int32 or float32 loads, got {a.dtype}")


def gamma(a: torch.Tensor) -> torch.Tensor:
    """The paper's Gamma array: exclusive prefix, shape (..., n1+1, n2+1),
    in ``a``'s dtype."""
    if a.ndim not in (2, 3):
        raise ValueError(f"gamma takes (n1, n2) or (B, n1, n2), got {a.ndim}D")
    _check_dtype("gamma", a)
    if _build.on_cpu("sat", a):
        return gamma_ref(a)
    x = a.contiguous()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    B, n1, n2 = x.shape
    _build.check_cuda("sat", x)
    g = torch.empty((B, n1 + 1, n2 + 1), dtype=x.dtype, device=x.device)
    _build.launch("sat", _FN[x.dtype], x, g, B, n1, n2)
    return g[0] if squeeze else g


def sat(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum (a view into :func:`gamma`'s result)."""
    return gamma(a)[..., 1:, 1:]


def gamma3(a: torch.Tensor) -> torch.Tensor:
    """Exclusive 3D prefix, shape (..., n1+1, n2+1, n3+1), in ``a``'s
    dtype."""
    if a.ndim not in (3, 4):
        raise ValueError(f"gamma3 takes (n1, n2, n3) or (B, n1, n2, n3), "
                         f"got {a.ndim}D")
    _check_dtype("gamma3", a)
    if _build.on_cpu("sat3", a):
        return gamma3_ref(a)
    x = a.contiguous()
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    B, n1, n2, n3 = x.shape
    _build.check_cuda("sat3", x)
    g = torch.empty((B, n1 + 1, n2 + 1, n3 + 1), dtype=x.dtype,
                    device=x.device)
    _build.launch("sat3", _FN3[x.dtype], x, g, B, n1, n2, n3)
    return g[0] if squeeze else g


def sat3(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 3D prefix sum (a view into :func:`gamma3`'s result)."""
    return gamma3(a)[..., 1:, 1:, 1:]
