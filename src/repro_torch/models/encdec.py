"""Whisper-style encoder-decoder backbone, plain PyTorch.

Counterpart of ``repro.models.encdec``.  The conv audio frontend is a
stub, as in the reference: the caller gives precomputed frame embeddings
(B, encoder_len, d_model).  The backbone is the reference's: a
bidirectional encoder, a causal decoder with self- and cross-attention,
learned absolute positions (no rope), plain GELU MLPs and RMSNorm.  The
parameter tree is the reference's, each stack's leaves on a leading
layer axis, and the head is the tied embedding.

Serving semantics copied from the reference:

- there is no cross-attention KV cache: every decode step projects the
  cross-attention keys and values again from ``cache["enc"]``;
- decoder positions wrap: token ``pos`` adds row ``pos % 4096`` of
  ``dec_pos``;
- the self-attention cache is written as ``layers.write_cache`` writes
  (the reference's own rule, ``encdec.py:115-127``, is the same for every
  case it allows), in place.

Training (``loss_fn``) checkpoints every encoder and decoder layer, as
the reference does, and scores the decoder's hidden states against the
tied embedding with ``lm.chunked_ce``.

Entry points (``init_params``, ``encode``, ``decode_train``, ``loss_fn``,
``init_cache``, ``prefill``, ``decode_step``) take ``device=None``, which
means the card, and raise ``RuntimeError`` where CUDA is absent; pass
``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.dist.ctx import constrain
from repro_torch.rebalance.planner import resolve_device

from . import layers as L
from .config import ModelConfig
from .lm import (_dtype, _index, _inputs, _positions, _stacked, _unstack,
                 checkpointed, chunked_ce)

Params = dict
#: rows of the decoder's learned positions; positions wrap past them
DEC_POS = 4096


def _mha(generator, cfg: ModelConfig, dtype, device, out=None) -> Params:
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    o = functools.partial(L.subtree, out)
    return {"wq": L.dense_init(generator, (d, H, dh), d, dtype, device,
                               o("wq")),
            "wk": L.dense_init(generator, (d, H, dh), d, dtype, device,
                               o("wk")),
            "wv": L.dense_init(generator, (d, H, dh), d, dtype, device,
                               o("wv")),
            "wo": L.dense_init(generator, (H, dh, d), H * dh, dtype, device,
                               o("wo"))}


def init_enc_layer(generator, cfg: ModelConfig, device, out=None) -> Params:
    """One encoder layer (attention, then the MLP), into ``out`` when
    given."""
    dt = _dtype(cfg)
    o = functools.partial(L.subtree, out)
    d = cfg.d_model
    return {"ln1": L.zeros((d,), dt, device, o("ln1")),
            "attn": _mha(generator, cfg, dt, device, o("attn")),
            "ln2": L.zeros((d,), dt, device, o("ln2")),
            "ffn": L.init_mlp(generator, cfg, dt, device, out=o("ffn"))}


def init_dec_layer(generator, cfg: ModelConfig, device, out=None) -> Params:
    """One decoder layer (self-attention, cross-attention, then the MLP),
    into ``out`` when given."""
    dt = _dtype(cfg)
    o = functools.partial(L.subtree, out)
    d = cfg.d_model
    return {"ln1": L.zeros((d,), dt, device, o("ln1")),
            "self": _mha(generator, cfg, dt, device, o("self")),
            "ln_x": L.zeros((d,), dt, device, o("ln_x")),
            "cross": _mha(generator, cfg, dt, device, o("cross")),
            "ln2": L.zeros((d,), dt, device, o("ln2")),
            "ffn": L.init_mlp(generator, cfg, dt, device, out=o("ffn"))}


def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                device=None) -> Params:
    """Random weights drawn from ``generator`` in the reference's order
    (encoder positions, encoder layers, embedding, decoder positions,
    decoder layers), laid out as the reference's tree; each layer written
    into its stack as it is drawn.  On the ``meta`` device the generator
    may be None: shapes only."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d = cfg.d_model

    def normal(rows, std):
        return L.normal(generator, (rows, d), dev).mul_(std).to(dt)

    def stack(init, n):
        layers = _stacked(init(None, cfg, "meta"), n, dev)
        if dev.type != "meta":
            for i in range(n):
                init(generator, cfg, dev, out=_index(layers, i))
        return layers

    p: Params = {"enc_pos": normal(cfg.encoder_len, 0.01)}
    p["enc_layers"] = stack(init_enc_layer, cfg.encoder_layers)
    p["enc_ln"] = torch.zeros((d,), dtype=dt, device=dev)
    p["embed"] = normal(cfg.padded_vocab, 0.02)
    p["dec_pos"] = normal(DEC_POS, 0.01)
    p["dec_layers"] = stack(init_dec_layer, cfg.n_layers)
    p["ln_f"] = torch.zeros((d,), dtype=dt, device=dev)
    return p


def _heads(x, w):
    """(B, S, d) @ (d, H, dh) -> (B, S, H, dh)."""
    return torch.einsum("bsd,dhk->bshk", x, w)


def _attention(cfg: ModelConfig, q, k, v, q_pos, kv_pos, causal: bool):
    return L.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=0, softcap=0.0,
                               scale=cfg.head_dim ** -0.5,
                               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)


def _attend(p: Params, cfg: ModelConfig, xq, xkv, q_pos, kv_pos,
            causal: bool):
    """Attention of ``xq``'s queries over ``xkv``'s keys and values, no
    window, no softcap; q, k and v hinted head-sharded over 'model'."""
    q = constrain(_heads(xq, p["wq"]), "dp", None, "model", None)
    k = constrain(_heads(xkv, p["wk"]), "dp", None, "model", None)
    v = constrain(_heads(xkv, p["wv"]), "dp", None, "model", None)
    out = _attention(cfg, q, k, v, q_pos, kv_pos, causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _enc_layer(lp: Params, cfg: ModelConfig, x, pos) -> torch.Tensor:
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    x = x + _attend(lp["attn"], cfg, h, h, pos, pos, causal=False)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_forward(lp["ffn"], cfg, h)


def _encode(p: Params, cfg: ModelConfig, frames,
            remat: bool = False) -> torch.Tensor:
    x = frames.to(_dtype(cfg)) + p["enc_pos"][None]
    B, T = x.shape[:2]
    pos = _positions(B, T, x.device)
    body = checkpointed(_enc_layer, remat)
    for lp in _unstack(p["enc_layers"], cfg.encoder_layers):
        x = body(lp, cfg, x, pos)
    return L.rmsnorm(x, p["enc_ln"], cfg.norm_eps)


def encode(p: Params, cfg: ModelConfig, frames, device=None) -> torch.Tensor:
    """frames: (B, encoder_len, d) stub embeddings, cast to the model dtype
    before ``enc_pos`` is added -> the encoder states (bidirectional)."""
    dev = resolve_device(device)
    (frames,) = _inputs(dev, p, None, frames)
    return _encode(p, cfg, frames)


def _dec_layer(lp: Params, cfg: ModelConfig, x, enc, pos, enc_pos,
               self_cache):
    """Returns x.  With a self-attention cache, the call's keys and values
    are written into it in place; a call with S > 1 (prefill) attends over
    its own, a call with S == 1 (decode) over the whole cache."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if self_cache is None:
        a = _attend(lp["self"], cfg, h, h, pos, pos, causal=True)
    else:
        q, k, v = (_heads(h, lp["self"][w]) for w in ("wq", "wk", "wv"))
        L.write_cache(self_cache, {"k": k, "v": v}, pos)
        if x.shape[1] == 1:
            k, v, kv_pos = self_cache["k"], self_cache["v"], self_cache["pos"]
        else:
            kv_pos = pos
        out = _attention(cfg, q, k, v, pos, kv_pos, causal=True)
        a = torch.einsum("bshk,hkd->bsd", out, lp["self"]["wo"])
    x = x + a
    h = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    x = x + _attend(lp["cross"], cfg, h, enc, pos, enc_pos, causal=False)
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_forward(lp["ffn"], cfg, h)


def _decoder(p: Params, cfg: ModelConfig, tokens, pos, enc, cache=None,
             remat: bool = False):
    """The decoder stack over ``tokens`` at positions ``pos`` (B, S), its
    learned positions read at ``pos % 4096``; returns the final-normed
    hidden states."""
    x = p["embed"][tokens] + p["dec_pos"][pos.long() % DEC_POS]
    enc_pos = _positions(enc.shape[0], enc.shape[1], enc.device)
    body = checkpointed(_dec_layer, remat)
    for i, lp in enumerate(_unstack(p["dec_layers"], cfg.n_layers)):
        x = body(lp, cfg, x, enc, pos, enc_pos,
                 None if cache is None else _index(cache["self"], i))
    return L.rmsnorm(x, p["ln_f"], cfg.norm_eps)


def _logits(p: Params, x) -> torch.Tensor:
    """The tied head: the product in the model dtype, then float32."""
    return (x @ p["embed"].T).float()


def decode_train(p: Params, cfg: ModelConfig, frames, tokens,
                 device=None) -> torch.Tensor:
    """Teacher-forced scoring: the logits (B, T, V) of every decoder
    position, the frames encoded first."""
    dev = resolve_device(device)
    frames, tokens = _inputs(dev, p, None, frames, tokens)
    return _logits(p, decode_hidden(p, cfg, frames, tokens))


def decode_hidden(p: Params, cfg: ModelConfig, frames, tokens,
                  remat: bool = False) -> torch.Tensor:
    """The decoder's final-normed hidden states over every position, the
    frames encoded first (tensors on the params' device); every layer of
    both stacks checkpointed when ``remat``."""
    enc = _encode(p, cfg, frames, remat=remat)
    B, T = tokens.shape
    return _decoder(p, cfg, tokens, _positions(B, T, tokens.device), enc,
                    remat=remat)


def loss_fn(p: Params, cfg: ModelConfig, batch, remat: bool = True,
            device=None):
    """The training objective: batch frames (B, encoder_len, d), tokens and
    labels (B, T).  The mean cross-entropy of the decoder's hidden states
    against the tied embedding (``lm.chunked_ce``, every weight 1).  The
    reference checkpoints both stacks whatever ``remat`` says; so does the
    port by default.  Returns (loss, {"nll": loss})."""
    dev = resolve_device(device)
    frames, tokens, labels = _inputs(dev, p, None, batch["frames"],
                                     batch["tokens"], batch["labels"])
    x = decode_hidden(p, cfg, frames, tokens, remat=remat)
    w = torch.ones(labels.shape, dtype=torch.float32, device=dev)
    loss = chunked_ce(lambda xc: _logits(p, xc), x, labels, w)
    return loss, {"nll": loss}


def init_cache(cfg: ModelConfig, batch: int, ctx: int, device=None) -> dict:
    """The decoder's self-attention cache (k, v and positions, -1 = empty,
    stacked on a leading L axis, ``ctx`` slots) and the encoder states
    ``enc`` (B, encoder_len, d) that ``prefill`` writes."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    Lz, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    return {
        "self": {"k": torch.zeros((Lz, batch, ctx, H, dh), dtype=dt,
                                  device=dev),
                 "v": torch.zeros((Lz, batch, ctx, H, dh), dtype=dt,
                                  device=dev),
                 "pos": torch.full((Lz, batch, ctx), -1, dtype=torch.int32,
                                   device=dev)},
        "enc": torch.zeros((batch, cfg.encoder_len, cfg.d_model), dtype=dt,
                           device=dev),
    }


def prefill(p: Params, cfg: ModelConfig, frames, tokens, cache,
            device=None):
    """Encode the frames into ``cache["enc"]`` and run the decoder prompt
    (every row at positions 0..T-1) into the self-attention cache; returns
    (last logits (B, 1, V), cache)."""
    dev = resolve_device(device)
    frames, tokens = _inputs(dev, p, cache, frames, tokens)
    cache["enc"].copy_(_encode(p, cfg, frames))
    B, T = tokens.shape
    x = _decoder(p, cfg, tokens, _positions(B, T, dev), cache["enc"], cache)
    return _logits(p, x[:, -1:]), cache


def decode_step(p: Params, cfg: ModelConfig, tokens, pos, cache,
                device=None):
    """One token per sequence.  tokens: (B, 1); pos: (B,) positions.  The
    cross-attention keys and values are projected again from
    ``cache["enc"]``.  Returns (logits (B, 1, V), cache)."""
    dev = resolve_device(device)
    tokens, pos = _inputs(dev, p, cache, tokens, pos)
    x = _decoder(p, cfg, tokens, pos.to(torch.int32)[:, None], cache["enc"],
                 cache)
    return _logits(p, x), cache
