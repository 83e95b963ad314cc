"""Wrappers of the flash attention kernel K5 (``flash.cu``).

A CUDA tensor goes through a kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.  Which kernel takes a
CUDA call is the C entry point's choice, by dtype and shape.  Up to a
head dim of 256: float32 the 3xTF32 tensor-core kernel (launch key
``flash_f32``); bfloat16 the Hopper kernel (``flash``) where TMA can
describe the tensors (d a multiple of 8, 16-byte aligned bases, at least
one key) and elsewhere the general kernel (``flash_general``: the same
``wgmma`` consumers behind a producer of threads); float16 the same two
kernels at float16 (``flash_f16``, ``flash_f16_general``).  Above 256,
at every dtype, ``flash_wide`` where TMA could describe the tensors (as
above) and d <= 576: one block a 64-row query tile with every output
column, so S is computed once a key tile (``wgmma`` at 16 bits, 3xTF32
at float32); ``flash_wide_general`` for the rest (Q and K streamed in
chunks of 64 columns, the output in slices of at most 256).  Each entry
point returns which kernel it launched, and the launch is counted under
that key.  The TPU kernel's tile sizes (``qc``, ``kc``) are not arguments
here: tiles belong to the kernel, and the result depends on them only
through the order of float summation.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

_FN = {torch.float32: "repro_flash_attn_f32",
       torch.bfloat16: "repro_flash_attn_bf16",
       torch.float16: "repro_flash_attn_f16"}
#: launch keys of the kernels each entry point chooses among, in the order
#: of its return codes (0, -1, -2, -3)
_KEYS = {torch.float32: ("flash_f32", "flash_wide", "flash_wide_general"),
         torch.bfloat16: ("flash", "flash_general", "flash_wide",
                          "flash_wide_general"),
         torch.float16: ("flash_f16", "flash_f16_general", "flash_wide",
                         "flash_wide_general")}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v all float16, all "
                        f"float32 or all bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention takes (BH, S, d) tensors")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must share "
                         f"BH and d, and k and v their length")
    if q.shape[2] < 1:
        raise ValueError(f"flash_attention: head dim {q.shape[2]} is below 1")
    if q.device != k.device or q.device != v.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device} and {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (BH, Sq, d), k, v: (BH, Skv, d), flattened batch*heads, all
    float32, all bfloat16 or all float16, any d >= 1.  Returns (BH, Sq, d)
    in the input dtype, computed in float32.  ``causal`` keeps key j <=
    query i (aligned top-left, also when Sq != Skv); ``window > 0`` keeps
    i - j < window; ``softcap > 0`` applies softcap * tanh(s / softcap)
    after the scale (default d ** -0.5)."""
    _check(q, k, v)
    BH, Sq, d = q.shape
    if scale is None:
        scale = float(d) ** -0.5
    if _build.on_cpu("flash", q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    o = torch.empty_like(q)
    _build.launch(_KEYS[q.dtype], _FN[q.dtype], q, k, v, o, BH, Sq,
                  k.shape[1], d, int(causal), int(window), float(softcap),
                  float(scale))
    return o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """(B, S, H, d) attention through :func:`flash_attention`, the heads
    folded into the batch axis: float32, bfloat16 or float16, any d >= 1.
    Returns (B, Sq, H, d) in the input dtype."""
    B, Sq, H, d = q.shape
    Skv = k.shape[1]
    qf = q.transpose(1, 2).reshape(B * H, Sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(B * H, Skv, d).contiguous()
    vf = v.transpose(1, 2).reshape(B * H, Skv, d).contiguous()
    of = flash_attention(qf, kf, vf, causal=causal, window=window,
                         softcap=softcap)
    return of.reshape(B, H, Sq, d).transpose(1, 2)
