"""Wrappers of the flash attention kernel K5 (``flash.cu``) and of the
realigning copy in front of its wide route (``realign.cu``).

A CUDA tensor goes through a kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.  Up to a head dim of 256
the C entry point chooses the kernel, by dtype and shape: float32 the
3xTF32 tensor-core kernel (launch key ``flash_f32``); bfloat16 the Hopper
kernel (``flash``) where TMA can describe the tensors (d a multiple of
8, 16-byte aligned bases, at least one key) and elsewhere the general
kernel (``flash_general``: the same ``wgmma`` consumers behind a producer
of threads); float16 the same two kernels at float16 (``flash_f16``,
``flash_f16_general``).  Above 256, at every dtype, four routes:

- ``flash_wide`` where TMA can describe the tensors and d <= 576
  (``WIDE_MAXD``): one block a 64-row query tile with every output
  column, so S is computed once a key tile (``wgmma`` at 16 bits, 3xTF32
  at float32);
- ``flash_wide_cluster`` where TMA can describe the tensors and 576 < d
  <= 4096 (``CLUSTER_MAXD``): the same block on a share of d's 64-column
  chunks, a cluster of 2-8 blocks a query tile (:func:`cluster_blocks`),
  each partial S summed once across the cluster through distributed
  shared memory (in ascending rank, so every block holds the same S);
- ``flash_realign`` then ``flash_wide`` or ``flash_wide_cluster`` for the
  other shapes with at least one key and d <= 4096 after padding (bases
  not 16-byte aligned, d % 8 != 0): :func:`realign_plan` names the
  tensors to copy, each judged by itself; :func:`pad8` copies each into
  fresh scratch with rows of dp = d rounded up to a multiple of 8
  (columns past d zero, which add nothing to S), the C entry point runs
  on the scratch with d = dp and the caller's scale (that of the real d),
  and where d % 8 != 0 the kernel writes a padded output that
  :func:`unpad8` cuts back to d columns.  The scratch costs one padded
  copy of each tensor copied: at (16, 4096, 576) bf16 on unaligned bases
  3 x 75.5 MB;
- ``flash_wide_general`` for the rest, d > 4096 after padding and Skv = 0
  (Q and K streamed in chunks of 64 columns, the output in slices of at
  most 256).

Each entry point returns which kernel it launched, and the launch is
counted under that key; each copy counts one ``flash_realign``.  The TPU
kernel's tile sizes (``qc``, ``kc``) are not arguments here: tiles belong
to the kernel, and the result depends on them only through the order of
float summation.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref, pad8_ref, unpad8_ref

_FN = {torch.float32: "repro_flash_attn_f32",
       torch.bfloat16: "repro_flash_attn_bf16",
       torch.float16: "repro_flash_attn_f16"}
#: launch keys of the kernels each entry point chooses among, in the order
#: of its return codes (0, -1, -2, ...)
_KEYS = {torch.float32: ("flash_f32", "flash_wide", "flash_wide_general",
                         "flash_wide_cluster"),
         torch.bfloat16: ("flash", "flash_general", "flash_wide",
                          "flash_wide_general", "flash_wide_cluster"),
         torch.float16: ("flash_f16", "flash_f16_general", "flash_wide",
                         "flash_wide_general", "flash_wide_cluster")}
#: widest head ``flash_wide`` takes (``hw::MAXD``, ``fw::MAXD`` in flash.cu)
WIDE_MAXD = 576
#: widest head ``flash_wide_cluster`` takes (``CLUSTER_MAXD`` in flash.cu):
#: 8 blocks a cluster, the most a portable cluster has, each owning at most
#: 8 of d's 64-column chunks
CLUSTER_MAXD = 4096


def wide_key(d: int, skv: int = 1) -> str:
    """The wide kernel that takes head dim ``d`` (> 256) with ``skv`` keys
    on bases TMA can describe, or after :func:`realign_plan`'s copies:
    ``flash_wide`` up to ``WIDE_MAXD`` after padding to a multiple of 8,
    ``flash_wide_cluster`` up to ``CLUSTER_MAXD``, ``flash_wide_general``
    past it and at ``skv`` = 0."""
    dp = padded(d)
    if skv == 0 or dp > CLUSTER_MAXD:
        return "flash_wide_general"
    return "flash_wide" if dp <= WIDE_MAXD else "flash_wide_cluster"


def cluster_blocks(d: int, elem_bytes: int) -> int:
    """Blocks a cluster ``flash_wide_cluster`` launches for head dim ``d``
    (a multiple of 8 in (``WIDE_MAXD``, ``CLUSTER_MAXD``]) at elements of
    ``elem_bytes``: flash.cu's own rule (``blocks_for``), read from the
    built library, so on the card only."""
    return _build.library().repro_flash_cluster_blocks(d, elem_bytes)


def cluster_blocks_seen() -> int:
    """Blocks a cluster the last ``flash_wide_cluster`` launch ran with, as
    the first block of its grid read them from ``%cluster_nctarank`` (0
    where none ran since the last call); the record is cleared.  Waits for
    the card; on the card only."""
    torch.cuda.synchronize()
    n = ctypes.c_int(0)
    err = _build.library().repro_flash_cluster_seen(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"repro_flash_cluster_seen failed with CUDA "
                           f"error {err}")
    return n.value


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


def padded(d: int) -> int:
    """d rounded up to a multiple of 8: the row width of the scratch."""
    return d + -d % 8


def realign_plan(residues: tuple[int, int, int], d: int,
                 skv: int) -> tuple[bool, bool, bool, bool] | None:
    """Which tensors the wide route copies into padded, aligned scratch:
    ``(q, k, v, o)`` for q, k and v whose data pointers are ``residues``
    mod 16, head dim ``d`` and ``skv`` keys; None where the C entry point
    takes the tensors as they are.

    ``flash_wide`` and ``flash_wide_cluster`` take what ``tma_shape``
    (flash.cu) admits, 16-byte aligned bases, d % 8 == 0 and Skv > 0, up
    to d = ``CLUSTER_MAXD``.  Above d = 256, with at least one key and d
    <= ``CLUSTER_MAXD`` after padding to a multiple of 8, every other
    shape becomes one of those: each of q, k and v is copied where its
    base is not 16-byte aligned or d % 8 != 0, and the output is padded
    where d % 8 != 0 (a fresh tensor is always aligned).  A choice by
    shape, not a fallback."""
    if d <= 256 or wide_key(d, skv) == "flash_wide_general":
        return None
    copy = tuple(r % 16 != 0 or d % 8 != 0 for r in residues)
    return (*copy, d % 8 != 0) if any(copy) else None


def _check_copy(x: torch.Tensor) -> None:
    if x.dtype not in _FN:
        raise TypeError(f"the realigning copy takes float16, float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.ndim < 1 or not x.is_contiguous():
        raise ValueError("the realigning copy needs a contiguous tensor")


def pad8(x: torch.Tensor) -> torch.Tensor:
    """(..., d) at any element boundary -> a fresh (..., dp) tensor, dp =
    d rounded up to a multiple of 8, the columns past d zero; on the card
    16-byte aligned with rows of a multiple of 16 bytes, what TMA can
    describe.  One ``flash_realign`` launch (none for an empty tensor)."""
    _check_copy(x)
    if _build.on_cpu("flash_realign", x):
        return pad8_ref(x)
    d = x.shape[-1]
    out = x.new_empty((*x.shape[:-1], padded(d)))
    if x.numel():
        _build.launch("flash_realign", "repro_flash_realign", x, out,
                      x.numel() // d, d, x.element_size(), 0)
    return out


def unpad8(x: torch.Tensor, d: int) -> torch.Tensor:
    """(..., dp) from :func:`pad8`'s layout -> a fresh contiguous (..., d)
    tensor of the first d columns.  One ``flash_realign`` launch (none for
    an empty tensor)."""
    _check_copy(x)
    if x.shape[-1] != padded(d):
        raise ValueError(f"unpad8: rows of {x.shape[-1]} do not pad d = {d}")
    if _build.on_cpu("flash_realign", x):
        return unpad8_ref(x, d)
    out = x.new_empty((*x.shape[:-1], d))
    if x.numel():
        _build.launch("flash_realign", "repro_flash_realign", x, out,
                      x.numel() // x.shape[-1], d, x.element_size(), 1)
    return out


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
    Skv = k.shape[1]
    plan = realign_plan(tuple(x.data_ptr() % 16 for x in (q, k, v)), d, Skv)
    if plan is None:
        o = torch.empty_like(q)
        _build.launch(_KEYS[q.dtype], _FN[q.dtype], q, k, v, o, BH, Sq, Skv,
                      d, int(causal), int(window), float(softcap),
                      float(scale))
        return o
    # the wide route on padded, aligned scratch (realign_plan); the scale
    # stays the caller's, that of the real d
    qs, ks, vs = (pad8(x) if c else x for x, c in zip((q, k, v), plan))
    dp = padded(d)
    o = q.new_empty((BH, Sq, dp)) if plan[3] else torch.empty_like(q)
    _build.launch(_KEYS[q.dtype], _FN[q.dtype], qs, ks, vs, o, BH, Sq, Skv,
                  dp, int(causal), int(window), float(softcap), float(scale))
    return unpad8(o, d) if plan[3] else o


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
