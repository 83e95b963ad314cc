"""Plain PyTorch version of the rectload kernel."""
from __future__ import annotations

import torch


def jagged_loads_ref(gamma: torch.Tensor, row_cuts: torch.Tensor,
                     col_cuts: torch.Tensor) -> torch.Tensor:
    """Loads of a jagged partition, in ``gamma``'s dtype.

    gamma: (n1+1, n2+1) exclusive 2D prefix sums.
    row_cuts: (P+1,) stripe boundaries.
    col_cuts: (P, Q+1) per-stripe column cuts.
    Returns (P, Q) loads: L[s, q] = sum of A[rc[s]:rc[s+1], cc[s,q]:cc[s,q+1]].

    A leading frame axis — (B, n1+1, n2+1) gamma with (B, P+1) /
    (B, P, Q+1) cuts — gives (B, P, Q).
    """
    if gamma.ndim == 2:
        return jagged_loads_ref(gamma[None], row_cuts[None], col_cuts[None])[0]
    rc = row_cuts.long()
    b = torch.arange(gamma.shape[0], device=gamma.device)[:, None]
    stripe_prefix = gamma[b, rc[:, 1:]] - gamma[b, rc[:, :-1]]  # (B, P, n2+1)
    vals = stripe_prefix.gather(-1, col_cuts.long())             # (B, P, Q+1)
    return vals[..., 1:] - vals[..., :-1]
