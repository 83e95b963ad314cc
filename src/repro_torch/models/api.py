"""Unified model API: every ported architecture exposes the same five
functions.

``build(cfg)`` returns a ``Model`` with:
  init(generator, device=None) -> params
  loss(params, batch, device=None) -> (loss, metrics)      # train objective
  prefill(params, batch, cache, device=None) -> (logits, cache)
  decode(params, tokens, pos, cache, device=None) -> (logits, cache)
  init_cache(batch_size, ctx, device=None) -> cache
plus ``*_spec`` functions giving stand-ins of the inputs, the cache and the
parameters: tensors on the ``meta`` device, of the reference's
``ShapeDtypeStruct`` shapes and dtypes, with nothing allocated.

The port's counterpart of ``repro.models.api`` for every family: the
decoder-only dense, VLM, MoE, SSM and hybrid ones (``lm``) and the
encoder-decoder (``encdec``, whose batches carry ``frames`` and
``tokens``).  ``device=None`` means the card (see ``lm``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import encdec, lm
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: encdec.init_params(
                generator, cfg, device),
            loss=lambda p, b, device=None: encdec.loss_fn(p, cfg, b,
                                                          device=device),
            prefill=lambda p, b, c, device=None: encdec.prefill(
                p, cfg, b["frames"], b["tokens"], c, device),
            decode=lambda p, t, pos, c, device=None: encdec.decode_step(
                p, cfg, t, pos, c, device),
            init_cache=lambda bsz, ctx, device=None: encdec.init_cache(
                cfg, bsz, ctx, device),
        )

    def _prefill(p, b, c, device=None):
        return lm.prefill(p, cfg, b["tokens"], c,
                          prefix_embeds=b.get("prefix_embeds"), device=device)

    return Model(
        cfg=cfg,
        init=lambda generator, device=None: lm.init_params(generator, cfg,
                                                           device),
        loss=lambda p, b, device=None: lm.loss_fn(p, cfg, b, device=device),
        prefill=_prefill,
        decode=lambda p, t, pos, c, device=None: lm.decode_step(
            p, cfg, t, pos, c, device),
        init_cache=lambda bsz, ctx, device=None: lm.init_cache(cfg, bsz, ctx,
                                                               device),
    )


# ---------------------------------------------------------------------------
# input specs (stand-ins on the meta device; nothing is allocated)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_spec(cfg: ModelConfig, global_batch: int, seq_len: int):
    """A training batch: tokens and labels (int32); an encoder-decoder's
    bf16 frames, or a VLM's bf16 prefix embeddings (its text then
    ``seq_len - vision_len`` tokens)."""
    i32, B = torch.int32, global_batch
    if cfg.family == "encdec":
        return {"frames": _meta((B, cfg.encoder_len, cfg.d_model),
                                torch.bfloat16),
                "tokens": _meta((B, seq_len), i32),
                "labels": _meta((B, seq_len), i32)}
    if cfg.family == "vlm":
        text = seq_len - cfg.vision_len
        return {"prefix_embeds": _meta((B, cfg.vision_len, cfg.d_model),
                                       torch.bfloat16),
                "tokens": _meta((B, text), i32),
                "labels": _meta((B, text), i32)}
    return {"tokens": _meta((B, seq_len), i32),
            "labels": _meta((B, seq_len), i32)}


def prefill_batch_spec(cfg: ModelConfig, global_batch: int, seq_len: int):
    spec = train_batch_spec(cfg, global_batch, seq_len)
    spec.pop("labels")
    return spec


def decode_inputs_spec(cfg: ModelConfig, global_batch: int):
    """(tokens (B, 1), positions (B,)), int32."""
    return (_meta((global_batch, 1), torch.int32),
            _meta((global_batch,), torch.int32))


def cache_spec(cfg: ModelConfig, global_batch: int, ctx: int):
    return build(cfg).init_cache(global_batch, ctx, device="meta")


def param_spec(cfg: ModelConfig):
    init = encdec.init_params if cfg.family == "encdec" else lm.init_params
    return init(None, cfg, device="meta")


def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, from the shapes of its tree on the ``meta``
    device: nothing is allocated."""
    return sum(t.numel() for t in lm.leaves(param_spec(cfg)))
