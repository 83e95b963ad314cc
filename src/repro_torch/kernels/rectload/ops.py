"""Wrapper of the rectload kernel (``rectload.cu``).

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import jagged_loads_ref

_FN = {torch.float32: "repro_rectload_f32", torch.int32: "repro_rectload_i32"}


def jagged_loads(gamma: torch.Tensor, row_cuts: torch.Tensor,
                 col_cuts: torch.Tensor) -> torch.Tensor:
    """float32 rectangle loads; a 2D Gamma with ``(P+1,)`` / ``(P, Q+1)``
    cuts gives ``(P, Q)``, a ``(B, n1+1, n2+1)`` stack with ``(B, P+1)`` /
    ``(B, P, Q+1)`` cuts gives ``(B, P, Q)``.  The differences are taken in
    Gamma's dtype and then cast, as ``jagged_loads_ref(...)`` followed by
    a float32 cast."""
    if gamma.ndim not in (2, 3) or row_cuts.ndim != gamma.ndim - 1 \
            or col_cuts.ndim != gamma.ndim:
        raise ValueError(f"jagged_loads takes Gamma (n1+1, n2+1) or "
                         f"(B, n1+1, n2+1) with matching cuts, got "
                         f"{tuple(gamma.shape)}, {tuple(row_cuts.shape)}, "
                         f"{tuple(col_cuts.shape)}")
    if gamma.dtype not in _FN:
        raise TypeError(f"jagged_loads takes an int32 or float32 Gamma, got "
                        f"{gamma.dtype}")
    if _build.on_cpu("rectload", gamma):
        return jagged_loads_ref(gamma, row_cuts, col_cuts).to(torch.float32)
    squeeze = gamma.ndim == 2
    g, rc, cc = ((gamma[None], row_cuts[None], col_cuts[None]) if squeeze
                 else (gamma, row_cuts, col_cuts))
    g = g.contiguous()
    rc = rc.to(torch.int32).contiguous()
    cc = cc.to(torch.int32).contiguous()
    B, n1p, n2p = g.shape
    P = rc.shape[1] - 1
    if rc.shape[0] != B or cc.shape[:2] != (B, P):
        raise ValueError(f"cuts {tuple(rc.shape)} / {tuple(cc.shape)} do not "
                         f"match {B} frames of {P} stripes")
    if n1p * n2p >= 2 ** 31:
        raise ValueError(f"rectload kernel indexes a frame in int32: "
                         f"({n1p}, {n2p}) is too large")
    _build.check_cuda("rectload", g, rc, cc)
    Qp1 = cc.shape[2]
    out = torch.empty((B, P, Qp1 - 1), dtype=torch.float32, device=g.device)
    _build.launch("rectload", _FN[g.dtype], g, rc, cc, out, B, n1p, n2p, P,
                  Qp1)
    return out[0] if squeeze else out
