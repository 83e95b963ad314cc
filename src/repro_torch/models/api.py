"""Unified model API: every ported architecture exposes the same five
functions.

``build(cfg)`` returns a ``Model`` with:
  init(generator, device=None) -> params
  loss(params, batch)                     # raises: training is not ported
  prefill(params, batch, cache, device=None) -> (logits, cache)
  decode(params, tokens, pos, cache, device=None) -> (logits, cache)
  init_cache(batch_size, ctx, device=None) -> cache

The port's counterpart of ``repro.models.api`` for the decoder-only
dense, VLM and MoE families (GQA or MLA attention); ``build`` raises
``NotImplementedError`` for the SSM, hybrid and encoder-decoder ones.
``device=None`` means the card (see ``lm``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import lm
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
    lm.require_ported(cfg)

    def _loss(p, b):
        raise NotImplementedError("training (loss_fn, chunked_ce) is not "
                                  "ported yet: ROADMAP.md queue 1, item 2 "
                                  "(training, data and launch)")

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
    return sum(t.numel()
               for t in lm.leaves(lm.init_params(None, cfg, device="meta")))
