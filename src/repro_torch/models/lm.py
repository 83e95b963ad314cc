"""Decoder-only language model: the dense, VLM, MoE, SSM and hybrid
families, with GQA or MLA attention, Mamba2 SSD layers or both.

Counterpart of ``repro.models.lm``.  The parameter tree is the
reference's: per-layer leaves stacked on a leading L axis, which the
layer loop unbinds (the reference scans over it).  The decode cache is
stacked the same way and written in place.

Training (``loss_fn``) takes gradients by autograd through the same
layers.  ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, as ``jax.checkpoint`` around the scanned
body), and ``chunked_ce`` never holds more than one chunk's logits: each
chunk is checkpointed, so the backward pass computes its logits again.

Serving semantics are the reference's, pads included: a left-padded
prompt is a sequence like any other, its pad tokens at positions
``0..`` attended by every later token; nothing masks them and no row's
positions are shifted.

Entry points (``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``prefill``, ``decode_step``, ``params_from_numpy``) take ``device=None``,
which means the card, and raise ``RuntimeError`` where CUDA is absent;
pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.rebalance.planner import resolve_device

from . import layers as L
from . import ssm as S
from .config import ModelConfig

Params = dict


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def leaves(tree) -> list:
    """The tensors of a parameter or cache tree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def _index(tree, i: int):
    """Layer ``i``'s slice of a tree stacked on a leading L axis (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The ``n`` layers' slices of a tree stacked on a leading L axis, each
    leaf unbound once (views): autograd then stacks the layers' gradients
    in one operation, where indexing layer by layer would add n full-size
    gradients."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def checkpointed(fn, on: bool):
    """``fn``, checkpointed when ``on``: its activations are not kept, and
    the backward pass runs it again (``jax.checkpoint``)."""
    if not on:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _stacked(tree, n: int, device):
    """Empty tensors of ``tree``'s leaves' shapes and dtypes with a leading
    axis of ``n``, on ``device``."""
    if isinstance(tree, dict):
        return {k: _stacked(v, n, device) for k, v in tree.items()}
    return torch.empty((n, *tree.shape), dtype=tree.dtype, device=device)


# ---------------------------------------------------------------------------
# init


def init_layer(generator, cfg: ModelConfig, device, out=None) -> Params:
    """One layer's weights drawn from ``generator`` (attention, then the
    SSD block, then the MLP or the experts, each where the model has it),
    written into ``out`` (a tree of its leaves' shapes) when given."""
    dt = _dtype(cfg)
    o = functools.partial(L.subtree, out)
    d = cfg.d_model
    p: Params = {"ln1": L.zeros((d,), dt, device, o("ln1"))}
    if cfg.uses_attention:
        init_attn = L.init_mla if cfg.attn_kind == "mla" else L.init_attn
        p["attn"] = init_attn(generator, cfg, dt, device, out=o("attn"))
    if cfg.uses_ssm:
        p["ssm"] = S.init_ssm(generator, cfg, dt, device, out=o("ssm"))
    if cfg.d_ff > 0:
        p["ln2"] = L.zeros((d,), dt, device, o("ln2"))
        init_ffn = L.init_moe if cfg.n_experts > 0 else L.init_mlp
        p["ffn"] = init_ffn(generator, cfg, dt, device, out=o("ffn"))
    if cfg.post_norms:
        p["pn1"] = L.zeros((d,), dt, device, o("pn1"))
        if cfg.d_ff > 0:
            p["pn2"] = L.zeros((d,), dt, device, o("pn2"))
    return p


def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                device=None) -> Params:
    """Random weights drawn from ``generator`` (embedding, then the layers
    in order, then the head), laid out as the reference's tree.  Each
    layer's leaves are written into the stacked tensors as they are drawn,
    so the peak is the weights plus one float32 draw.  On the ``meta``
    device the generator may be None: shapes only."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    V = cfg.padded_vocab
    layers = _stacked(init_layer(None, cfg, "meta"), cfg.n_layers, dev)
    p: Params = {
        "embed": L.normal(generator, (V, cfg.d_model), dev).mul_(0.02).to(dt),
        "ln_f": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "layers": layers,
    }
    if dev.type != "meta":
        for i in range(cfg.n_layers):
            init_layer(generator, cfg, dev, out=_index(layers, i))
    if not cfg.tie_embeddings:
        p["head"] = L.normal(generator, (cfg.d_model, V),
                             dev).mul_(0.02).to(dt)
    return p


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> Params:
    """The reference's parameter tree of any family (nested dicts of NumPy
    arrays, the per-layer leaves stacked on a leading L axis; the
    encoder-decoder's as ``encdec.init_params`` lays it out) as the
    port's, each leaf in its dtype in the port's tree (``cfg.dtype``; the
    SSM's ``A_log``, ``D``, ``dt_bias`` and the MoE router float32) on
    ``device``.  bfloat16 leaves come as float32 arrays (bf16 -> float32
    -> bf16 is lossless), so no bfloat16 NumPy type is needed.  Raises
    ``ValueError`` where the tree's keys or shapes are not those of
    ``cfg``."""
    from . import encdec        # encdec builds on this module
    dev = resolve_device(device)
    init = encdec.init_params if cfg.family == "encdec" else init_params
    spec = init(None, cfg, device="meta")

    def conv(s, a, path):
        if isinstance(s, dict):
            if not isinstance(a, dict) or set(a) != set(s):
                got = sorted(a) if isinstance(a, dict) else type(a).__name__
                raise ValueError(f"params{path}: keys {got}, expected "
                                 f"{sorted(s)} for {cfg.name}")
            return {k: conv(s[k], a[k], f"{path}[{k!r}]") for k in s}
        t = torch.tensor(np.asarray(a))
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"params{path}: shape {tuple(t.shape)}, "
                             f"expected {tuple(s.shape)} for {cfg.name}")
        return t.to(device=dev, dtype=s.dtype)

    return conv(spec, tree, "")


# ---------------------------------------------------------------------------
# layer body


def _window_for_layer(cfg: ModelConfig, layer_idx: int) -> int:
    """Layer ``layer_idx``'s attention window (0 = full attention): with
    ``global_every = k``, layer i is global when i % k == k - 1."""
    if cfg.sliding_window == 0:
        return 0
    if cfg.global_every > 0 and (
            layer_idx % cfg.global_every == cfg.global_every - 1):
        return 0
    return cfg.sliding_window


def layer_forward(p: Params, cfg: ModelConfig, x, positions, layer_idx: int,
                  cache=None):
    """Returns (x, new_cache, aux): ``aux`` is the MoE balancing loss (a
    float32 tensor), 0.0 for a layer without experts.  MLA attends in its
    latent space (absorbed) exactly when there is a cache and S == 1.  A
    hybrid layer mixes its attention and SSD outputs as ``(attn + ssm) *
    0.5`` in the activation dtype."""
    aux = 0.0
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    mix = None
    new_cache = {}
    if cfg.uses_attention:
        window = _window_for_layer(cfg, layer_idx)
        acache = None if cache is None else cache["attn"]
        if cfg.attn_kind == "mla":
            mix, nc = L.mla_forward(
                p["attn"], cfg, h, positions, window=window, cache=acache,
                absorb=acache is not None and h.shape[1] == 1)
        else:
            mix, nc = L.attn_forward(p["attn"], cfg, h, positions,
                                     window=window, cache=acache)
        if nc is not None:
            new_cache["attn"] = nc
    if cfg.uses_ssm:
        s, new_cache["ssm"] = S.ssm_forward(
            p["ssm"], cfg, h, cache=None if cache is None else cache["ssm"])
        mix = s if mix is None else (mix + s) * 0.5
    if cfg.post_norms:
        mix = L.rmsnorm(mix, p["pn1"], cfg.norm_eps)
    x = x + mix
    if cfg.d_ff > 0:
        h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.n_experts > 0:
            f, aux = L.moe_forward(p["ffn"], cfg, h2)
        else:
            f = L.mlp_forward(p["ffn"], cfg, h2)
        if cfg.post_norms:
            f = L.rmsnorm(f, p["pn2"], cfg.norm_eps)
        x = x + f
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# full forward


def _embed(p: Params, cfg: ModelConfig, tokens, prefix_embeds=None):
    x = p["embed"][tokens]
    if cfg.scale_embed:
        # sqrt(d) in float32, then in the activation dtype (bf16: 59.75
        # for d = 3584), as the reference scales
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _head(p: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """Logits over the padded vocabulary: the product in the model dtype,
    then float32, then the softcap."""
    x = L.rmsnorm(x, p["ln_f"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    logits = (x @ w).float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _layers(p: Params, cfg: ModelConfig, x, positions, cache=None,
            remat: bool = False):
    """The layer stack: (x, the mean of the layers' aux losses), each layer
    checkpointed when ``remat`` (training, without a cache)."""
    aux = 0.0
    body = checkpointed(layer_forward, remat)
    for i, lp in enumerate(_unstack(p["layers"], cfg.n_layers)):
        x, _, a = body(lp, cfg, x, positions, i,
                       cache=None if cache is None else _index(cache, i))
        aux = aux + a
    return x, aux / cfg.n_layers


def _inputs(dev: torch.device, p: Params, cache, *arrays):
    """The inputs on ``dev`` (NumPy arrays or tensors); the params and the
    cache must already be there."""
    dev = torch.empty(0, device=dev).device     # "cuda" -> "cuda:0"
    for t in leaves(p) + ([] if cache is None else leaves(cache)):
        if t.device != dev:
            raise ValueError(f"params and cache must be on {dev}, found a "
                             f"tensor on {t.device}")
    return [None if a is None else torch.as_tensor(a, device=dev)
            for a in arrays]


def _positions(B: int, T: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)


def forward(p: Params, cfg: ModelConfig, tokens, prefix_embeds=None,
            device=None):
    """Scoring forward: (logits over the whole sequence, aux).  ``aux`` is
    the reference's MoE balancing loss averaged over the layers (0 without
    experts)."""
    dev = resolve_device(device)
    tokens, prefix_embeds = _inputs(dev, p, None, tokens, prefix_embeds)
    x = _embed(p, cfg, tokens, prefix_embeds)
    B, T = x.shape[:2]
    x, aux = _layers(p, cfg, x, _positions(B, T, dev))
    return _head(p, cfg, x), torch.as_tensor(aux, dtype=torch.float32,
                                             device=dev)


def _hidden(p: Params, cfg: ModelConfig, tokens, prefix_embeds=None,
            remat: bool = False):
    """The final hidden states before the head, and the mean aux loss."""
    x = _embed(p, cfg, tokens, prefix_embeds)
    B, T = x.shape[:2]
    return _layers(p, cfg, x, _positions(B, T, x.device), remat=remat)


def chunked_ce(head_fn, x, labels, weights, chunk: int = 512):
    """The weighted mean cross-entropy of ``head_fn(x)`` (float32 logits)
    against ``labels``, without materialising (B, S, V) logits: over
    sequence chunks of min(chunk, S), ``x``, the labels and the weights
    zero-padded to a whole number of chunks, each chunk checkpointed so
    that the backward pass computes its logits again.  The sums of the
    weighted losses and of the weights run over the chunks in order, from
    float32 zeros, as the reference's scan carries them; the mean divides
    by max(sum of weights, 1)."""
    B, S, d = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))

    def body(xc, lc, wc):
        logits = head_fn(xc)                                   # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lc.long()[..., None])[..., 0]
        return ((lse - ll) * wc).sum(), wc.sum()

    num = den = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[1], c):
        n, w = checkpoint(body, x[:, i:i + c], labels[:, i:i + c],
                          weights[:, i:i + c], use_reentrant=False)
        num, den = num + n, den + w
    return num / torch.clamp(den, min=1.0)


def loss_fn(p: Params, cfg: ModelConfig, batch, remat: bool = True,
            device=None):
    """The training objective.  batch: tokens (B, S), labels (B, Tt),
    optional weights (B, Tt) and a VLM's prefix_embeds (NumPy arrays or
    tensors).  The loss covers the last Tt positions (a VLM's text), and
    adds ``0.01 * aux`` for a model with experts.  Returns (loss, {"nll":
    loss, "aux": the mean aux loss}), float32 scalars."""
    dev = resolve_device(device)
    tokens, labels, pe, w = _inputs(dev, p, None, batch["tokens"],
                                    batch["labels"],
                                    batch.get("prefix_embeds"),
                                    batch.get("weights"))
    x, aux = _hidden(p, cfg, tokens, pe, remat=remat)
    Tt = labels.shape[1]
    x = x[:, -Tt:]
    w = (torch.ones(labels.shape, dtype=torch.float32, device=dev)
         if w is None else w.float())
    loss = chunked_ce(lambda xc: _head(p, cfg, xc), x, labels, w)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    if cfg.n_experts > 0:
        loss = loss + 0.01 * aux
    return loss, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def init_cache(cfg: ModelConfig, batch: int, ctx: int, device=None) -> dict:
    """Per-layer cache stacked on a leading L axis.  Attention (where the
    model has it): a window-bounded model keeps min(ctx, window) slots (a
    ring), any other ctx; GQA keeps k and v per KV head, MLA the latent
    ``c`` and the shared rope key ``kr``.  SSD layers (where the model has
    them): the float32 ``state`` (B, H, d_inner // H, N) and the conv's
    ``conv`` tail (B, K-1, d_inner + 2N), whatever ``ctx`` is."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    Lz = cfg.n_layers
    c: dict = {}
    if cfg.uses_attention:
        sc = min(ctx, cfg.sliding_window) if cfg.bounded_kv else ctx
        if cfg.attn_kind == "mla":
            entries = {"c": (cfg.kv_lora_rank,), "kr": (cfg.qk_rope_dim,)}
        else:
            entries = {"k": (cfg.n_kv_heads, cfg.head_dim),
                       "v": (cfg.n_kv_heads, cfg.head_dim)}
        attn = {k: torch.zeros((Lz, batch, sc, *shape), dtype=dt,
                               device=dev)
                for k, shape in entries.items()}
        attn["pos"] = torch.full((Lz, batch, sc), -1, dtype=torch.int32,
                                 device=dev)
        c["attn"] = attn
    if cfg.uses_ssm:
        H, N = cfg.ssm_heads, cfg.ssm_state
        c["ssm"] = {
            "state": torch.zeros((Lz, batch, H, cfg.d_inner // H, N),
                                 dtype=torch.float32, device=dev),
            "conv": torch.zeros((Lz, batch, cfg.conv_kernel - 1,
                                 cfg.d_inner + 2 * N), dtype=dt, device=dev)}
    return c


def prefill(p: Params, cfg: ModelConfig, tokens, cache, prefix_embeds=None,
            device=None):
    """Fill the cache with a prompt (every row at positions 0..T-1);
    returns (last logits (B, 1, V), cache)."""
    dev = resolve_device(device)
    tokens, prefix_embeds = _inputs(dev, p, cache, tokens, prefix_embeds)
    x = _embed(p, cfg, tokens, prefix_embeds)
    B, T = x.shape[:2]
    x, _ = _layers(p, cfg, x, _positions(B, T, dev), cache=cache)
    return _head(p, cfg, x[:, -1:]), cache


def decode_step(p: Params, cfg: ModelConfig, tokens, pos, cache, device=None):
    """One token per sequence.  tokens: (B, 1); pos: (B,) positions.
    Returns (logits (B, 1, V), cache)."""
    dev = resolve_device(device)
    tokens, pos = _inputs(dev, p, cache, tokens, pos)
    x = _embed(p, cfg, tokens)
    x, _ = _layers(p, cfg, x, pos.to(torch.int32)[:, None], cache=cache)
    return _head(p, cfg, x), cache
