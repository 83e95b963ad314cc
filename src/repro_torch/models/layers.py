"""Shared neural layers, plain PyTorch: norms, rotary embeddings, the
chunked (flash-style) attention, the GQA and MLA attention blocks, the
MLPs and the mixture of experts.

Counterpart of ``repro.models.layers``: float32 norm, softmax and router
arithmetic with the model dtype's weights and activations, as there.  The
parameters are plain dicts of tensors laid out as the reference's trees,
so a tree converted from the reference (``lm.params_from_numpy``) runs
here unchanged.

Every initialiser takes ``out=None``: given a tree of tensors of its
leaves' shapes (a layer's slice of the stacked parameters), it writes
each leaf there as it is drawn and returns that tree, so a stack of
layers is filled without per-layer copies.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core.device import _fma_f32
from repro_torch.dist.ctx import constrain, current_mesh

from .config import ModelConfig

Params = dict

# ---------------------------------------------------------------------------
# init helpers


def normal(generator: torch.Generator | None, shape, device) -> torch.Tensor:
    """Standard normal float32 draws from ``generator`` (on the
    generator's own device), moved to ``device``.  On the ``meta`` device
    nothing is drawn or allocated: only the shape exists."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def dense_init(generator, shape, in_axis_size, dtype, device,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Normal weights of variance ``1 / in_axis_size``, drawn in float32 and
    cast to ``dtype`` (into ``out`` when given)."""
    w = normal(generator, shape, device).mul_(1.0 / math.sqrt(in_axis_size))
    return w.to(dtype) if out is None else out.copy_(w)


def zeros(shape, dtype, device, out: torch.Tensor | None = None):
    """A leaf that starts at zero (a norm's scale), into ``out`` when
    given."""
    if out is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return out.zero_()


def subtree(out, key: str):
    """``out[key]``, or None where there is no ``out`` tree."""
    return None if out is None else out[key]


# ---------------------------------------------------------------------------
# norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32 with the ``(1 + scale)`` gain (scales start at
    zero), cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings

_F32 = functools.partial(torch.tensor, dtype=torch.float32)
# XLA's float32 exp on the CPU: Cephes' range reduction and polynomial,
# every multiply-add fused; the input clamped to [-87.8, 88.8] and the
# exponent n to [-127, 127], so that exp(x) for x in [88.376, 88.723) is
# the polynomial at a reduced argument up to 0.77 times 2**127, and
# results below 2**-126 are flushed to zero
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E, _HALF = _F32(1.44269504088896341), _F32(0.5)
_EXP_C1, _EXP_C2 = _F32(-0.693359375), _F32(2.12194440e-4)
_EXP_P = [_F32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                            4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)]


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, bit for bit as XLA computes it on the
    CPU (P13, P17) over the whole float32 range: -inf and every result
    below 2**-126 give 0, +inf gives inf, NaN stays NaN.  The reference's
    rotary frequencies come from it, and one ulp of a frequency moves the
    angle at position 2**16 by 4e-3."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(_fma_f32(x, _LOG2E, _HALF)).clamp(-127, 127)
    r = _fma_f32(fx, _EXP_C2, _fma_f32(fx, _EXP_C1, x))
    y = _fma_f32(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma_f32(y, r, c)
    y = torch.ldexp(1.0 + _fma_f32(y, r * r, r), fx)
    return torch.where(y < 2.0 ** -126, 0.0, y)


@functools.lru_cache(maxsize=16)
def _inv_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies ``exp(-i * log(theta) / half)``, i < half, in
    float32 as the reference computes them, made once per device."""
    step = torch.log(_F32(theta)) / half
    return xla_exp(-torch.arange(half, dtype=torch.float32) * step).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) integers.  The rotate-half
    convention, angles in float32."""
    half = x.shape[-1] // 2
    freqs = _inv_freq(half, float(theta), x.device)
    ang = positions.float()[..., None] * freqs              # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention, plain PyTorch


def _mask_bias(iq: torch.Tensor, jk: torch.Tensor, *, causal: bool,
               window) -> torch.Tensor:
    """iq: (B, qc), jk: (B, kc) global positions (-1 = padding).  Returns
    the additive bias (B, qc, kc) of 0 / -inf.  ``window`` is an int or a
    0-d integer tensor; <= 0 disables the sliding-window constraint."""
    ok = (jk >= 0)[:, None, :]
    d = iq[:, :, None] - jk[:, None, :]
    if causal:
        ok = ok & (d >= 0)
    ok = ok & ((d < window) | (window <= 0))
    return torch.where(ok, 0.0, -torch.inf).to(torch.float32)


def chunk_stacks(q, k, v, q_pos, kv_pos, q_chunk: int, kv_chunk: int):
    """``chunked_attention``'s operands cut into chunks: q, k, v and the
    positions padded to whole chunks of min(q_chunk, Sq) and
    min(kv_chunk, Skv) (pad positions -1) and stacked chunk-major,
    ``(nq, B, qc, H, dk)``, ``(nq, B, qc)``, ``(nk, B, kc, Hkv, dk)``,
    ``(nk, B, kc, Hkv, dv)``, ``(nk, B, kc)``, with the active mesh's
    layout hints."""
    B, Sq, H, dk = q.shape
    _, Skv, Hkv, dv = v.shape
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    pq = (-Sq) % qc
    pk = (-Skv) % kc
    pad = torch.nn.functional.pad
    q = pad(q, (0, 0, 0, 0, 0, pq))
    q_pos = pad(q_pos, (0, pq), value=-1)
    k = pad(k, (0, 0, 0, 0, 0, pk))
    v = pad(v, (0, 0, 0, 0, 0, pk))
    kv_pos = pad(kv_pos, (0, pk), value=-1)
    nq, nk = q.shape[1] // qc, k.shape[1] // kc

    qb = q.reshape(B, nq, qc, H, dk).transpose(0, 1)
    qpb = q_pos.reshape(B, nq, qc).transpose(0, 1)
    kb = k.reshape(B, nk, kc, Hkv, dk).transpose(0, 1)
    vb = v.reshape(B, nk, kc, Hkv, dv).transpose(0, 1)
    kpb = kv_pos.reshape(B, nk, kc).transpose(0, 1)
    mesh = current_mesh()
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if Sq > 1:
        if H % tp == 0 and Hkv % tp == 0:
            # the chunk stacks head-sharded, only where the head axis
            # divides the TP axis (else the hint would force replication)
            qb = constrain(qb, None, "dp", None, "model", None)
            kb = constrain(kb, None, "dp", None, "model", None)
            vb = constrain(vb, None, "dp", None, "model", None)
    else:
        # decode: the chunks stay sequence-sharded over 'model'
        kb = constrain(kb, None, "dp", "model", None, None)
        vb = constrain(vb, None, "dp", "model", None, None)
    return qb, qpb, kb, vb, kpb


def attention_band(band_window: int, causal: bool, Sq: int, qc: int,
                   kc: int, nk: int) -> int:
    """The kv chunks a q chunk visits under a uniform sliding window of
    ``band_window`` (causal prefill only), 0 for all of them."""
    if band_window > 0 and causal and Sq > 1:
        return min(-(-band_window // kc) + -(-qc // kc) + 1, nk)
    return 0


def kv_blocks(iq_blk: int, qc: int, kc: int, nk: int, band: int,
              band_window: int) -> range:
    """The kv chunks q chunk ``iq_blk`` visits: all ``nk``, or with a
    ``band`` (uniform sliding-window prefill) the ``band`` chunks within
    [iq_blk*qc - band_window, iq_blk*qc + qc); provably masked chunks are
    skipped (the position masks still guard correctness)."""
    if not band:
        return range(nk)
    first_needed = (iq_blk * qc - (band_window - 1)) // kc
    start = min(max(first_needed, 0), nk - band)
    return range(start, start + band)


def online_start(B: int, H: int, qc: int, dv: int, device):
    """A q chunk's online-softmax state: running max, sum and output."""
    m = torch.full((B, H, qc), -torch.inf, dtype=torch.float32, device=device)
    l = torch.zeros((B, H, qc), dtype=torch.float32, device=device)
    acc = torch.zeros((B, H, qc, dv), dtype=torch.float32, device=device)
    return m, l, acc


def online_step(m, l, acc, qi, qp, ki, vi, kp, *, mqa: bool, causal: bool,
                window, softcap: float, scale: float):
    """One (q chunk, kv chunk) pair folded into the state (float32)."""
    if mqa:
        s = torch.einsum("bqhd,bkd->bhqk", qi.float(),
                         ki[:, :, 0].float()) * scale
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qi.float(), ki.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    bias = _mask_bias(qp, kp, causal=causal, window=window)
    s = s + bias[:, None, :, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + p.sum(dim=-1)
    if mqa:
        pv = torch.einsum("bhqk,bkd->bhqd", p, vi[:, :, 0].float())
    else:
        pv = torch.einsum("bhqk,bkhd->bhqd", p, vi.float())
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def online_end(m, l, acc) -> torch.Tensor:
    """A q chunk's output (B, qc, H, dv), float32."""
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2)


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool, window,
                      softcap: float, scale: float, q_chunk: int,
                      kv_chunk: int, band_window: int = 0) -> torch.Tensor:
    """Memory-efficient attention with online softmax.

    q, k, v: (B, S, H, d) with a FLAT, equal head count (callers repeat GQA
    KV heads first); MQA (k/v with a single head) broadcasts in the einsum
    without materializing the repeat.  q_pos: (B, Sq); kv_pos: (B, Skv)
    with -1 marking invalid cache slots.  ``band_window > 0`` (causal
    prefill only) visits just the kv chunks a uniform sliding window of
    that width can reach.  Never materializes more than (B, H, qc, kc)
    logits.  Returns (B, Sq, H, dv) in ``v``'s dtype.

    The stages (``chunk_stacks``, ``attention_band``, ``kv_blocks``,
    ``online_start``, ``online_step``, ``online_end``) are functions of
    their own so that
    ``launch.op_cost`` can count one q chunk and one visited pair and
    multiply them by their trips.
    """
    B, Sq, H, _ = q.shape
    Hkv, dv = v.shape[2], v.shape[3]
    mqa = (Hkv == 1 and H > 1)
    qb, qpb, kb, vb, kpb = chunk_stacks(q, k, v, q_pos, kv_pos, q_chunk,
                                        kv_chunk)
    nq, qc, nk, kc = qb.shape[0], qb.shape[2], kb.shape[0], kb.shape[2]
    band = attention_band(band_window, causal, Sq, qc, kc, nk)
    outs = []
    for iq_blk in range(nq):
        qi, qp = qb[iq_blk], qpb[iq_blk]   # (B, qc, H, dk), (B, qc)
        state = online_start(B, H, qc, dv, q.device)
        for j in kv_blocks(iq_blk, qc, kc, nk, band, band_window):
            state = online_step(*state, qi, qp, kb[j], vb[j], kpb[j],
                                mqa=mqa, causal=causal, window=window,
                                softcap=softcap, scale=scale)
        outs.append(online_end(*state))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, d) -> (B, S, Hkv * n_rep, d), grouped-query expansion."""
    if n_rep == 1:
        return k
    B, S, Hkv, d = k.shape
    k = k[:, :, :, None, :].expand(B, S, Hkv, n_rep, d)
    return k.reshape(B, S, Hkv * n_rep, d)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + cache handling)


def write_cache(cache: dict, new: dict, positions: torch.Tensor) -> dict:
    """Write one call's entries (``new``: (B, S, ...) tensors by cache key)
    and their positions into ``cache`` in place, as the reference does, and
    return it.  A call with S > 1 (prefill) writes its last min(S, Sc)
    entries, contiguously from slot 0 when they fit or wrap exactly, else
    at ``pos % Sc``; a call with S == 1 (decode) writes slot ``pos % Sc``."""
    B, S = positions.shape
    Sc = cache["pos"].shape[1]
    W = min(S, Sc)
    new = {**new, "pos": positions}
    if S > 1 and (Sc >= S or (W == Sc and S % Sc == 0)):
        for key, v in new.items():
            cache[key][:, :W] = v[:, S - W:]
    else:
        slots = positions[:, S - W:] % Sc
        bidx = torch.arange(B, device=positions.device)[:, None]
        for key, v in new.items():
            cache[key][bidx, slots] = v[:, S - W:]
    return cache


def init_attn(generator, cfg: ModelConfig, dtype, device,
              out=None) -> Params:
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    o = functools.partial(subtree, out)
    p = {
        "wq": dense_init(generator, (d, H, dh), d, dtype, device, o("wq")),
        "wk": dense_init(generator, (d, Hkv, dh), d, dtype, device, o("wk")),
        "wv": dense_init(generator, (d, Hkv, dh), d, dtype, device, o("wv")),
        "wo": dense_init(generator, (H, dh, d), H * dh, dtype, device,
                         o("wo")),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros((dh,), dtype, device, o("q_norm"))
        p["k_norm"] = zeros((dh,), dtype, device, o("k_norm"))
    return p


def attn_forward(p: Params, cfg: ModelConfig, x, positions, *, window,
                 cache=None):
    """GQA attention.  Returns (out, new_cache).

    cache: dict(k=(B, Sc, Hkv, dh), v=..., pos=(B, Sc)) or None; it is
    written in place (``write_cache``) and returned.  A call with S > 1
    (prefill) attends over its own k/v; a call with S == 1 (decode) over
    the whole cache, empty slots (pos -1) masked.  Every token is attended
    by position alone: there is no pad mask.
    """
    B, S, d = x.shape
    rep = cfg.n_heads // cfg.n_kv_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "dp", None, "model", None)

    new_cache = None
    k_all, v_all, kv_pos = k, v, positions
    if cache is not None:
        new_cache = write_cache(cache, {"k": k, "v": v}, positions)
        if S == 1:
            k_all, v_all, kv_pos = cache["k"], cache["v"], cache["pos"]

    # flat-head GQA: the repeated KV heads shard over 'model' for
    # compute-bound shapes; decode keeps the cache sequence-sharded instead
    decode_like = cache is not None and S == 1
    kv_spec = (("dp", "model", None, None) if decode_like
               else ("dp", None, "model", None))
    k_all = constrain(repeat_kv(k_all, rep), *kv_spec)
    v_all = constrain(repeat_kv(v_all, rep), *kv_spec)
    # banded prefill/train only for uniform sliding-window archs (the
    # window must be a static layer-independent bound)
    band_window = (cfg.sliding_window
                   if cfg.sliding_window > 0 and cfg.global_every == 0
                   and not decode_like else 0)
    out = chunked_attention(
        q, k_all, v_all, positions, kv_pos,
        causal=True, window=window, softcap=cfg.attn_softcap,
        scale=cfg.head_dim ** -0.5, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk, band_window=band_window)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2)


def init_mla(generator, cfg: ModelConfig, dtype, device, out=None) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    r, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    o = functools.partial(subtree, out)
    return {
        "wq_a": dense_init(generator, (d, r), d, dtype, device, o("wq_a")),
        "q_norm": zeros((r,), dtype, device, o("q_norm")),
        "wq_b": dense_init(generator, (r, H, qk), r, dtype, device,
                           o("wq_b")),
        "wkv_a": dense_init(generator, (d, kvr + cfg.qk_rope_dim), d, dtype,
                            device, o("wkv_a")),
        "kv_norm": zeros((kvr,), dtype, device, o("kv_norm")),
        "wkv_b": dense_init(generator,
                            (kvr, H, cfg.qk_nope_dim + cfg.v_head_dim), kvr,
                            dtype, device, o("wkv_b")),
        "wo": dense_init(generator, (H, cfg.v_head_dim, d),
                         H * cfg.v_head_dim, dtype, device, o("wo")),
    }


def mla_forward(p: Params, cfg: ModelConfig, x, positions, *, window,
                cache=None, absorb: bool = False):
    """Multi-head latent attention.  Returns (out, new_cache).

    cache: dict(c=(B, Sc, kv_lora_rank), kr=(B, Sc, qk_rope_dim),
    pos=(B, Sc)) or None: only the normed latent and the one shared rope
    key, written in place as the GQA cache is (``write_cache``).  Both
    paths scale the logits by ``(qk_nope_dim + qk_rope_dim) ** -0.5``.
    ``absorb=True`` (the reference's decode: a cache and S == 1) folds
    ``wkv_b``'s key half into the queries (``q_lat``, rounded to the model
    dtype) and attends in the latent space, one key head shared by every
    query head, then expands through ``wkv_b``'s value half; otherwise
    ``wkv_b`` expands the latents into per-head keys and values and the
    rope key is broadcast over the heads.
    """
    B, S, d = x.shape
    nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    scale = (nope + rdim) ** -0.5

    q = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q, p["wq_b"])
    q = constrain(q, "dp", None, "model", None)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], positions,
                                         cfg.rope_theta)
    kv = x @ p["wkv_a"]
    c = rmsnorm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., kvr:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0]                  # one head

    new_cache = None
    c_all, kr_all, kv_pos = c, k_rope, positions
    if cache is not None:
        new_cache = write_cache(cache, {"c": c, "kr": k_rope}, positions)
        if S == 1:
            c_all, kr_all, kv_pos = cache["c"], cache["kr"], cache["pos"]

    attend = functools.partial(
        chunked_attention, q_pos=positions, kv_pos=kv_pos, causal=True,
        window=window, softcap=0.0, scale=scale, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk)
    if absorb:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope,
                             p["wkv_b"][..., :nope])          # (B, S, H, r)
        k_cat = torch.cat([c_all, kr_all], dim=-1)[:, :, None, :]
        out_lat = attend(torch.cat([q_lat, q_rope], dim=-1), k_cat,
                         c_all[:, :, None, :])
        out = torch.einsum("bshr,rhv->bshv", out_lat, p["wkv_b"][..., nope:])
    else:
        kvu = torch.einsum("bsr,rhk->bshk", c_all, p["wkv_b"])
        kvu = constrain(kvu, "dp", None, "model", None)
        k_nope, v = kvu[..., :nope], kvu[..., nope:]
        k_full = torch.cat([k_nope, kr_all[:, :, None, :].expand(
            *k_nope.shape[:3], rdim)], dim=-1)
        out = attend(torch.cat([q_nope, q_rope], dim=-1), k_full, v)
    return torch.einsum("bshv,hvd->bsd", out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(generator, cfg: ModelConfig, dtype, device,
             d_ff: int | None = None, out=None) -> Params:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    o = functools.partial(subtree, out)
    if cfg.act in ("silu", "geglu"):  # gated
        return {"w1": dense_init(generator, (d, f), d, dtype, device, o("w1")),
                "w3": dense_init(generator, (d, f), d, dtype, device, o("w3")),
                "w2": dense_init(generator, (f, d), f, dtype, device, o("w2"))}
    return {"w1": dense_init(generator, (d, f), d, dtype, device, o("w1")),
            "w2": dense_init(generator, (f, d), f, dtype, device, o("w2"))}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: x / (1 + exp(-x)) op
    by op, each rounded to ``x``'s dtype (P14)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, as the reference computes
    it: op by op in ``x``'s dtype, its constants rounded to that dtype
    (P14; in bf16 sqrt(2/pi) is 0.796875)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp_forward(p: Params, cfg: ModelConfig, x) -> torch.Tensor:
    """silu and geglu are gated; gelu is plain (whisper)."""
    if cfg.act == "silu":
        h = silu(x @ p["w1"]) * (x @ p["w3"])
    elif cfg.act == "geglu":
        h = gelu(x @ p["w1"]) * (x @ p["w3"])
    else:  # plain gelu (whisper)
        h = gelu(x @ p["w1"])
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style one-hot dispatch, small token groups)


def moe_capacity(cfg: ModelConfig) -> int:
    """Slots per expert and dispatch group, from ``cfg.moe_group`` (not from
    the group a call actually has), rounded up to a multiple of 8."""
    slots = cfg.moe_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor
    return max(8, int(-(-slots // 8) * 8))


def moe_padded_len(cfg: ModelConfig, B: int, S: int) -> int:
    """The smallest length >= S to pad a batch of B prompts to so that
    ``moe_forward`` takes it (P15): B*S <= moe_group, or moe_group divides
    B*S.  S itself for a model without experts."""
    n = S
    while cfg.n_experts and not (B * n <= cfg.moe_group
                                 or B * n % cfg.moe_group == 0):
        n += 1
    return n


def init_moe(generator, cfg: ModelConfig, dtype, device, out=None) -> Params:
    """The router is float32 whatever ``dtype`` is, as the reference's."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    o = functools.partial(subtree, out)
    p = {
        "router": dense_init(generator, (d, E), d, torch.float32, device,
                             o("router")),
        "w1": dense_init(generator, (E, d, f), d, dtype, device, o("w1")),
        "w3": dense_init(generator, (E, d, f), d, dtype, device, o("w3")),
        "w2": dense_init(generator, (E, f, d), f, dtype, device, o("w2")),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, cfg, dtype, device,
                               d_ff=cfg.d_ff * cfg.n_shared_experts,
                               out=o("shared"))
    return p


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, in
    descending order, ties to the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


@dataclasses.dataclass
class Routing:
    """One MoE call's routing, by dispatch group (G groups of g tokens):
    ``probs`` (G, g, E) the router's float32 softmax; ``ids`` (G, g, k) the
    experts chosen, most probable first; ``vals`` (G, g, k) their weights,
    renormalised over the k; ``slots`` (G, g, k) each choice's place in its
    expert's queue, token-major then choice rank (kept where below
    ``capacity``); ``aux`` the load-balancing loss."""
    probs: torch.Tensor
    ids: torch.Tensor
    vals: torch.Tensor
    slots: torch.Tensor
    capacity: int
    aux: torch.Tensor

    @property
    def dropped(self) -> int:
        """Choices past their expert's capacity: computed, weighted 0."""
        return int((self.slots >= self.capacity).sum())


def moe_route(p: Params, cfg: ModelConfig, xg: torch.Tensor) -> Routing:
    """Route the tokens ``xg`` (G, g, d): float32 router logits and softmax,
    the top k, capacity slots and the Switch balancing loss
    ``E * sum_e mean(probs_e) * mean(count_e)``."""
    E, k = cfg.n_experts, cfg.top_k
    G, g, _ = xg.shape
    probs = torch.softmax(torch.einsum("gtd,de->gte", xg.float(),
                                       p["router"]), dim=-1)
    vals, ids = top_k(probs, k)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    oh = torch.nn.functional.one_hot(ids, E)                  # (G, g, k, E)
    aux = E * torch.sum(probs.mean(dim=(0, 1))
                        * oh.sum(dim=2).float().mean(dim=(0, 1)))
    ohf = oh.reshape(G, g * k, E)
    slots = ((torch.cumsum(ohf, dim=1) - ohf) * ohf).sum(-1).reshape(G, g, k)
    return Routing(probs, ids, vals, slots, moe_capacity(cfg), aux)


def moe_forward(p: Params, cfg: ModelConfig, x) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Returns (out, aux_loss).  x: (B, S, d), cut into groups of
    g = min(moe_group, B*S) tokens; ``ValueError`` where g does not divide
    B*S (the reference asserts).  Every expert computes all of its
    ``moe_capacity`` slots, empty and dropped ones included (the one-hot
    dispatch), and the shared experts' MLP is added after."""
    B, S, d = x.shape
    T = B * S
    g = min(cfg.moe_group, T)
    G = T // g
    if G * g != T:
        raise ValueError(f"moe_group {g} must divide tokens {T} (B={B}, "
                         f"S={S}): pad S so that B*S <= moe_group or "
                         f"moe_group divides B*S")
    xg = x.reshape(G, g, d)
    r = moe_route(p, cfg, xg)
    C = r.capacity
    cdt = (torch.bfloat16 if cfg.moe_combine_dtype == "bfloat16"
           else torch.float32)
    oh = torch.nn.functional.one_hot(r.ids, cfg.n_experts).to(cdt)
    wk = r.vals.to(cdt) * (r.slots < C).to(cdt)               # (G, g, k)
    slot_oh = (r.slots[..., None] == torch.arange(
        C, device=x.device)).to(cdt)                          # (G, g, k, C)
    combine = torch.einsum("gske,gsk,gskc->gsec", oh, wk, slot_oh)
    dispatch = (combine > 0).to(x.dtype)                      # (G, g, E, C)

    ein = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    h = silu(torch.einsum("gecd,edf->gecf", ein, p["w1"]))
    h = h * torch.einsum("gecd,edf->gecf", ein, p["w3"])
    out_e = torch.einsum("gecf,efd->gecd", h, p["w2"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), out_e)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp_forward(p["shared"], cfg, x)
    return y, r.aux
