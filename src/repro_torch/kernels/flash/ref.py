"""Plain PyTorch version of the flash attention kernel (K5)."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """q: (BH, Sq, d), k, v: (BH, Skv, d), flattened batch*heads.  Dense
    softmax attention in float32 with optional causal mask, sliding window
    and logit softcap; the result is cast to ``v``'s dtype."""
    Sq, Skv = q.shape[1], k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    iq = torch.arange(Sq, device=q.device)[:, None]
    jk = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= jk <= iq
    if window > 0:
        ok &= iq - jk < window
    s = torch.where(ok[None], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully masked rows
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(v.dtype)
