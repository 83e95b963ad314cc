"""Mamba2 SSD (state-space duality) block, plain PyTorch, chunked scan.

Counterpart of ``repro.models.ssm``: the minimal SSD algorithm (Dao & Gu
2024) with one group, a within-chunk quadratic form and an across-chunk
linear recurrence.  Decode is the O(1) recurrent step; its cache is the
(H, P, N) float32 state and the depthwise conv's tail, whatever the
context's length.

Numerics copied from the reference (each held by
``tests/test_torch_ssm.py``):

- the cumulative sums run in XLA's CPU order (``cumsum``), so the
  segment sums are the reference's bit for bit;
- ``ssm_compute_dtype="bfloat16"`` rounds the scan's operands and its
  decay and state intermediates to bf16 where the reference does, while
  every contraction runs in float32 (the reference's
  ``preferred_element_type``) and the cumulative sums and exps stay
  float32;
- softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``;
- the conv sums its K taps in order in the activation dtype, and silu
  runs op by op in that dtype (P14).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig

Params = dict
#: XLA's CPU cumulative sum adds sequentially within blocks of this many
#: entries, and offsets each block by the same scan of the block totals
_SCAN_BLOCK = 16


def init_ssm(generator, cfg: ModelConfig, dtype, device, out=None) -> Params:
    """The SSD block's weights: the input projection (z, x, B, C, dt), the
    depthwise conv, float32 ``A_log``, ``D`` and ``dt_bias`` (0, 1, 0),
    the output norm and projection."""
    d, di, N, Hs = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.conv_kernel
    f32 = torch.float32
    o = functools.partial(L.subtree, out)
    return {
        "w_in": L.dense_init(generator, (d, 2 * di + 2 * N + Hs), d, dtype,
                             device, o("w_in")),
        "conv": L.dense_init(generator, (K, di + 2 * N), K, dtype, device,
                             o("conv")),
        "A_log": L.zeros((Hs,), f32, device, o("A_log")),
        "D": L.zeros((Hs,), f32, device, o("D")).fill_(1.0),
        "dt_bias": L.zeros((Hs,), f32, device, o("dt_bias")),
        "out_norm": L.zeros((di,), dtype, device, o("out_norm")),
        "w_out": L.dense_init(generator, (di, d), di, dtype, device,
                              o("w_out")),
    }


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, in the order XLA's CPU
    computes ``jnp.cumsum`` (each add rounded to ``x``'s dtype):
    sequentially within blocks of 16 entries, each block offset by the
    cumulative sum (in the same order) of the totals before it.
    ``torch.cumsum`` adds in float64 on the CPU and in parallel on the
    card, so neither gives the reference's last bits."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[..., i].add_(out[..., i - 1])
        return out
    nb = -(-n // _SCAN_BLOCK)
    inner = cumsum(F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK))
    offsets = F.pad(cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + offsets[..., None]).flatten(-2)[..., :n]


def _pairwise(cs: torch.Tensor) -> torch.Tensor:
    """(..., l) cumulative sums -> (..., l, l) with out[i, j] = cs[i] -
    cs[j], -inf above the diagonal."""
    n = cs.shape[-1]
    out = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(n, device=cs.device)
    return torch.where(i[:, None] >= i[None, :], out, -torch.inf)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) -> (..., l, l) with out[i, j] = sum_{j < t <= i} x[t]
    (as a difference of cumulative sums), -inf above the diagonal."""
    return _pairwise(cumsum(x))


def _ssd_chunked(xdt, dA, Bm, Cm, chunk: int, h0=None):
    """Core SSD.  xdt: (b, S, H, P) pre-multiplied by dt; dA: (b, S, H)
    float32 (= dt * A, negative); Bm, Cm: (b, S, N).  Returns (y, final
    state), both float32.

    The decay matrix and the chunk states are rounded to ``xdt``'s dtype
    (bf16 under ``ssm_compute_dtype="bfloat16"``), and every contraction
    takes its operands in float32, as the reference contracts with
    ``preferred_element_type=float32``.  The four-operand product of the
    diagonal blocks is contracted C.B over n first, then L, then X."""
    b, S, H, P = xdt.shape
    cdt = xdt.dtype
    N = Bm.shape[-1]
    nc = S // chunk
    X = xdt.reshape(b, nc, chunk, H, P).float()
    A = dA.reshape(b, nc, chunk, H).permute(0, 3, 1, 2)      # (b, H, nc, l)
    Bc = Bm.reshape(b, nc, chunk, N).float()
    Cc = Cm.reshape(b, nc, chunk, N).float()

    A_cs = cumsum(A)                                         # (b, H, nc, l)

    # 1. intra-chunk (diagonal blocks)
    Lm = torch.exp(_pairwise(A_cs)).to(cdt).float()          # (b,H,nc,l,l)
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * Lm, X)

    # 2. chunk-final states
    decay_states = torch.exp(A_cs[..., -1:] - A_cs).to(cdt).float()
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          decay_states.permute(0, 2, 3, 1)[..., None] * X)

    # 3. inter-chunk recurrence
    if h0 is None:
        h0 = torch.zeros_like(states[:, 0])
    states = torch.cat([h0.float()[:, None], states], dim=1)  # (b, nc+1, ..)
    z = F.pad(A_cs[..., -1], (1, 0))                          # (b, H, nc+1)
    decay_chunk = torch.exp(_segsum(z))                       # (b,H,nc+1,nc+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states = new_states[:, :-1].to(cdt).float()
    final_state = new_states[:, -1]

    # 4. state -> output
    state_decay = torch.exp(A_cs).to(cdt).float()             # (b,H,nc,l)
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * state_decay.permute(0, 2, 3, 1)[..., None]

    Y = (Y_diag + Y_off).reshape(b, S, H, P)
    return Y, final_state


def _causal_conv(u, w, tail=None):
    """Depthwise causal conv.  u: (B, S, D); w: (K, D); tail: (B, K-1, D)
    the context before u (the cache's), zeros when None.  The K taps are
    summed in order in u's dtype.  Returns (y, the new tail: the last K-1
    rows of tail and u together)."""
    K = w.shape[0]
    S = u.shape[1]
    if tail is None:
        tail = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    ext = torch.cat([tail, u], dim=1)
    y = ext[:, :S] * w[0]
    for i in range(1, K):
        y = y + ext[:, i:i + S] * w[i]
    return y, (ext[:, -(K - 1):] if K > 1 else tail)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def chunk_size(cfg: ModelConfig, S: int) -> int:
    """The chunked scan's chunk for S tokens: the largest divisor of S not
    above ``cfg.ssm_chunk`` (so a prime S above it runs in chunks of 1)."""
    return max(c for c in range(1, min(cfg.ssm_chunk, S) + 1) if S % c == 0)


def ssm_forward(p: Params, cfg: ModelConfig, x, *, cache=None):
    """x: (B, S, d).  cache: dict(state=(B, H, P, N) float32, conv=(B, K-1,
    d_inner + 2N)) or None; it is written in place and returned.  With a
    cache and S == 1 this is the O(1) recurrent step (a one-token prompt
    too); otherwise the chunked scan (``chunk_size``), from the cache's
    state when there is one.  Returns (out, new_cache)."""
    B, S, d = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H

    zxbcdt = x @ p["w_in"]
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_out, new_tail = _causal_conv(
        torch.cat([xin, Bm, Cm], dim=-1), p["conv"],
        None if cache is None else cache["conv"])
    xin, Bm, Cm = torch.split(L.silu(conv_out), [di, N, N], dim=-1)

    dt = softplus(dt.float() + p["dt_bias"])                  # (B, S, H)
    A = -torch.exp(p["A_log"])                                # (H,)
    xh = xin.reshape(B, S, H, P).float()

    if cache is not None and S == 1:
        # recurrent step: h' = h * exp(dt A) + dt * B x ; y = C h + D x
        dA = torch.exp(dt[:, 0] * A)                          # (B, H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xh[:, 0])
        h = cache["state"] * dA[..., None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
        y = (y + p["D"][None, :, None] * xh[:, 0])[:, None]  # (B, 1, H, P)
        new_state = h
    else:
        cdt = (torch.bfloat16 if cfg.ssm_compute_dtype == "bfloat16"
               else torch.float32)
        xdt = (xh * dt[..., None]).to(cdt)
        h0 = None if cache is None else cache["state"]
        y, new_state = _ssd_chunked(xdt, dt * A, Bm.to(cdt), Cm.to(cdt),
                                    chunk_size(cfg, S), h0=h0)
        y = y + p["D"][None, None, :, None] * xh

    y = y.reshape(B, S, di).to(x.dtype)
    y = L.rmsnorm(y * L.silu(z), p["out_norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if cache is None:
        return out, {"state": new_state, "conv": new_tail}
    cache["state"].copy_(new_state)
    cache["conv"].copy_(new_tail)
    return out, cache
