"""Plain PyTorch version of the summed-area table kernel (2D part of
``repro.kernels.sat.ref``)."""
from __future__ import annotations

import torch


def sat_ref(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum: out[..., i, j] = a[..., :i+1, :j+1].sum().

    Batched inputs ``(B, n1, n2)`` prefix each frame independently (the
    scan axes are the trailing two).  The sums stay in ``a``'s dtype, as
    ``jnp.cumsum`` keeps them (``torch.cumsum`` alone would widen int32 to
    int64).
    """
    return torch.cumsum(torch.cumsum(a, dim=-2, dtype=a.dtype), dim=-1,
                        dtype=a.dtype)


def gamma_from_sat(s: torch.Tensor) -> torch.Tensor:
    """Embed an inclusive SAT as the paper's exclusive Gamma: one zero row
    and column prepended, shape (..., n1+1, n2+1)."""
    out = s.new_zeros(s.shape[:-2] + (s.shape[-2] + 1, s.shape[-1] + 1))
    out[..., 1:, 1:] = s
    return out


def gamma_ref(a: torch.Tensor) -> torch.Tensor:
    """Exclusive 2D prefix sum (the paper's Gamma), shape (..., n1+1, n2+1)."""
    return gamma_from_sat(sat_ref(a))
