"""Plain PyTorch versions of the summed-area table kernels K1 (2D) and K4
(3D): the port of ``repro.kernels.sat.ref``."""
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


def sat3_ref(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 3D prefix sum over the trailing three axes, taken along
    axis -3, then -2, then -1 (the reference's order).

    Batched inputs ``(B, n1, n2, n3)`` prefix each frame independently; a
    rank-3 input is one frame.  A separate entry point from
    :func:`sat_ref` because rank 3 is ambiguous between a ``(B, n1, n2)``
    2D stack and one ``(n1, n2, n3)`` volume.
    """
    s = torch.cumsum(a, dim=-3, dtype=a.dtype)
    s = torch.cumsum(s, dim=-2, dtype=a.dtype)
    return torch.cumsum(s, dim=-1, dtype=a.dtype)


def gamma3_from_sat(s: torch.Tensor) -> torch.Tensor:
    """Embed an inclusive 3D SAT as the exclusive Gamma: one zero plane
    prepended on each trailing axis, shape (..., n1+1, n2+1, n3+1)."""
    out = s.new_zeros(s.shape[:-3] + (s.shape[-3] + 1, s.shape[-2] + 1,
                                      s.shape[-1] + 1))
    out[..., 1:, 1:, 1:] = s
    return out


def gamma3_ref(a: torch.Tensor) -> torch.Tensor:
    """Exclusive 3D prefix sum, shape (..., n1+1, n2+1, n3+1)."""
    return gamma3_from_sat(sat3_ref(a))
