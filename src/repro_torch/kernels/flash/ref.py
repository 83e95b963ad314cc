"""Plain PyTorch versions of the flash attention kernel (K5) and of the
realigning copy in front of its wide route (``realign.cu``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                  scale: float | None = None) -> torch.Tensor:
    """q: (BH, Sq, d), k, v: (BH, Skv, d), flattened batch*heads, of any
    floating dtype and head dim (the kernels take float32, bfloat16 and
    float16).  Dense softmax attention in float32 with optional causal
    mask, sliding window and logit softcap; the result is cast to ``v``'s
    dtype."""
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


def attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int, softcap: float) -> torch.Tensor:
    """K5's function computed in float64, the yardstick of float32 where
    the logits are large (there :func:`attention_ref`, which computes in
    float32, is itself off by more than float32's contract).  Returns
    float64."""
    q, k, v = q.double(), k.double(), v.double()
    Sq, Skv, d = q.shape[1], k.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q, k) * d ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= i - j < window
    s = torch.where(ok[None], s, -torch.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bqk,bkd->bqd", p, v)


def pad8_ref(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> a fresh (..., dp) copy, dp = d rounded up to a multiple
    of 8, the columns past d zero."""
    return F.pad(x, (0, -x.shape[-1] % 8))


def unpad8_ref(x: torch.Tensor, d: int) -> torch.Tensor:
    """(..., dp) -> a fresh contiguous (..., d) copy of the first d
    columns."""
    return x[..., :d].contiguous()
