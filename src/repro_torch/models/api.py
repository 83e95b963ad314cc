"""Unified model API: every ported architecture exposes the same five
functions.

``build(cfg)`` returns a ``Model`` with:
  init(generator, device=None) -> params
  loss(params, batch)                     # raises: training is not ported
  prefill(params, batch, cache, device=None) -> (logits, cache)
  decode(params, tokens, pos, cache, device=None) -> (logits, cache)
  init_cache(batch_size, ctx, device=None) -> cache

The port's counterpart of ``repro.models.api`` for every family: the
decoder-only dense, VLM, MoE, SSM and hybrid ones (``lm``) and the
encoder-decoder (``encdec``, whose batches carry ``frames`` and
``tokens``).  ``device=None`` means the card (see ``lm``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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


def _loss(p, b):
    raise NotImplementedError("training (loss_fn, chunked_ce) is not ported "
                              "yet: ROADMAP.md queue 1, item 2 (training, "
                              "data and launch)")


def build(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: encdec.init_params(
                generator, cfg, device),
            loss=_loss,
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
        loss=_loss,
        prefill=_prefill,
        decode=lambda p, t, pos, c, device=None: lm.decode_step(
            p, cfg, t, pos, c, device),
        init_cache=lambda bsz, ctx, device=None: lm.init_cache(cfg, bsz, ctx,
                                                               device),
    )


def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, from the shapes of its tree on the ``meta``
    device: nothing is allocated."""
    init = encdec.init_params if cfg.family == "encdec" else lm.init_params
    return sum(t.numel() for t in lm.leaves(init(None, cfg, device="meta")))
