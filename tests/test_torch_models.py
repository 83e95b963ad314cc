"""The port's model stack against the JAX package, on the CPU: every
config, the decoder-only families and the encoder-decoder.

The same NumPy inputs and the reference's own parameters (from
``repro.models.lm.init_params`` or ``repro.models.encdec.init_params``,
every norm scale and the SSM's ``A_log``, ``D`` and ``dt_bias`` set to
non-zero random values on both sides, converted by
``lm.params_from_numpy``) go through both packages.

Tolerances:

- float32: max |port - reference| <= 1e-4 x max |reference| (``F32``),
  on logits and on every cache entry (attention k and v, the SSM's state
  and conv tail, the encoder-decoder's self-attention k and v and its
  encoder states); the cache's positions equal.  The measured differences
  are near 1e-6 x: float32 sums in another order.
  The layer functions are held tighter where their arithmetic is the
  reference's own (rope's frequencies, the bf16 activations: bit for bit).
- bfloat16 (the configs' own dtype): ``BF16`` = 4e-2 x max |reference|.
  Each op rounds to bf16 as in the reference, but the norms' float32 sums
  (XLA sums in windows of 32) and XLA's rsqrt (not correctly rounded)
  differ from torch's in the last float32 bit, which flips the bf16
  rounding of a few activations; over two layers and the head the
  measured differences reach 1.8e-2 x (about five bf16 ulps of the
  largest logit).
- MoE routing (``Routings``): the expert ids and capacity slots of every
  MoE call equal the reference's, except where a near tie flips (``TIE``:
  1e-6 relative at float32; at bf16, where the router's inputs differ by
  those few ulps, 4e-2).  A batch row that holds such a token is left out
  of the comparisons that follow it: one other expert is another output.
- ``aux``: 1e-6 x the reference's at float32, ``BF16`` x at bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch import configs
from repro_torch.models import api, encdec, layers, lm

from _torch_models_parity import (BF16, CPU, F32, TIE, TOL, Routings,
                                  assert_cache, assert_close, both_params,
                                  encdec_matches, host, inputs, jx,
                                  port_init)

#: the configurations the port runs: dense, VLM, (with MLA) MoE, SSM,
#: hybrid and encoder-decoder, every one the reference has
PORTED = ["qwen3_0_6b", "granite_3_2b", "gemma2_9b", "stablelm_1_6b",
          "internvl2_2b", "mixtral_8x7b", "deepseek_v2_236b", "mamba2_1_3b",
          "hymba_1_5b", "whisper_large_v3"]


# ---------------------------------------------------------------------------
# configs and parameter trees


@pytest.mark.parametrize("getter", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_configs_equal_the_reference(arch, getter):
    assert configs.ARCHS == jax_configs.ARCHS
    assert configs.canonical(arch.replace("_", "-")) == arch
    port, ref = getattr(configs, getter)(arch), getattr(jax_configs,
                                                        getter)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("d_inner", "padded_vocab", "uses_attention", "uses_ssm",
                 "bounded_kv"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert dataclasses.asdict(port.scaled(sliding_window=8)) == \
        dataclasses.asdict(ref.scaled(sliding_window=8))


@pytest.mark.parametrize("arch", PORTED)
def test_count_params_equals_the_reference(arch):
    assert api.count_params(configs.get(arch)) == \
        jax_api.count_params(jax_configs.get(arch))


@pytest.mark.parametrize("arch", PORTED)
def test_param_tree_is_the_reference_tree(arch):
    """Keys, shapes and dtypes of the port's seeded init (on the CPU) and
    of its meta tree equal the reference's param spec."""
    cfg = configs.get_smoke(arch)
    spec = jax.tree_util.tree_flatten_with_path(
        jax_api.param_spec(jax_configs.get_smoke(arch)))[0]
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in spec}
    gen = torch.Generator().manual_seed(0)
    init = port_init(cfg)
    for tree in (init(gen, cfg, device=CPU), init(None, cfg, device="meta")):
        got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                         str(v.dtype).split(".")[1])
               for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert got == want


def test_params_from_numpy_refuses_another_tree():
    (jcfg, jp), (tcfg, _) = both_params("qwen3_0_6b", "float32")
    tree = jax.tree.map(host, jp)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match=r"\['wq'\]: shape"):
        lm.params_from_numpy(tree, tcfg, device=CPU)
    del tree["ln_f"]
    with pytest.raises(ValueError, match="keys"):
        lm.params_from_numpy(tree, tcfg, device=CPU)


def test_params_from_numpy_is_lossless_in_bf16():
    """bf16 leaves cross as float32 and come back bit for bit."""
    (jcfg, jp), (tcfg, tp) = both_params("gemma2_9b", "bfloat16")
    got = jax.tree_util.tree_flatten_with_path(tp)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for k, v in got:
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(host(v), host(want[k]))


def test_inputs_must_share_the_params_device():
    cfg = configs.get_smoke("qwen3_0_6b")
    meta = lm.init_params(None, cfg, device="meta")
    with pytest.raises(ValueError, match="must be on cpu"):
        lm.forward(meta, cfg, np.zeros((1, 3), np.int32), device=CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3584, 64])
def test_embed_scale_is_cast_first(d, dtype):
    """``scale_embed``: sqrt(d) is cast to the activation dtype before the
    product (bf16: 59.75 for d = 3584), bit for bit."""
    jcfg = jax_configs.get("gemma2_9b").scaled(d_model=d, dtype=dtype)
    tcfg = configs.get("gemma2_9b").scaled(d_model=d, dtype=dtype)
    jdt = jnp.dtype(dtype)
    table = jnp.asarray(np.random.default_rng(0).standard_normal((8, d)),
                        jdt)
    toks = np.array([[3, 0, 7]], np.int32)
    ref = jax_lm._embed({"embed": table}, jcfg, jnp.asarray(toks))
    got = lm._embed({"embed": torch.from_numpy(host(table)).to(
        getattr(torch, dtype))}, tcfg, torch.from_numpy(toks))
    np.testing.assert_array_equal(host(got), host(ref))


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((2, 7, 64)) * 3, jdt)
    s = jnp.asarray(rng.standard_normal(64) * 0.5, jdt)
    got = layers.rmsnorm(torch.from_numpy(host(x)).to(getattr(torch, dtype)),
                         torch.from_numpy(host(s)).to(getattr(torch, dtype)),
                         1e-6)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, jax_layers.rmsnorm(x, s, 1e-6), 1e-6, "rmsnorm")


def test_xla_exp_is_the_reference_exp():
    """P13 and P17: the port's ``xla_exp`` is XLA's float32 exp on the CPU,
    bit for bit (``jax.jit(jnp.exp)``), over the whole float32 range: the
    rotary frequencies' arguments, 10**6 random bit patterns (every
    exponent, denormals, infinities, NaNs), a sweep of [-110, 90], 10**5
    draws in [-120, -80] (results below 2**-126 flushed to 0) and in [88,
    88.8] (finite up to 88.7228, then inf), the edges -87.3365 and
    88.3763 with 64 neighbouring floats on each side, +-inf and NaN."""
    rng = np.random.default_rng(0)
    args = [-rng.uniform(0, 20, 100_000).astype(np.float32)]
    for theta in (1e4, 1e6):
        for half in (8, 16, 32, 64, 128):
            step = np.float32(np.asarray(jnp.log(theta)) / np.float32(half))
            args.append(-np.arange(half, dtype=np.float32) * step)
    args += [rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint64).astype(
                 np.uint32).view(np.float32),
             np.linspace(-110, 90, 1_000_001, dtype=np.float32),
             rng.uniform(-120, -80, 100_000).astype(np.float32),
             rng.uniform(88, 88.8, 100_000).astype(np.float32),
             np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)]
    for edge in (-87.3365, 88.3763):
        below = above = np.float32(edge)
        args.append(np.array([below], np.float32))
        for _ in range(64):
            below = np.nextafter(below, np.float32(-np.inf))
            above = np.nextafter(above, np.float32(np.inf))
            args.append(np.array([below, above], np.float32))
    x = np.concatenate(args)
    got = layers.xla_exp(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.exp)(x))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    assert nan.sum() == np.isnan(x).sum() > 1000
    assert (got[x < -87.34] == 0).all()
    assert np.isfinite(got[(x >= 88.37627) & (x < 88.72283)]).all()
    assert got[x == np.inf] == np.inf


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dh", [16, 32, 128])
def test_rope_matches(theta, dh):
    """Positions up to 2**16: float32 angles of bit-identical frequencies,
    so the outputs differ by the trigonometry's last bit (limit 1e-6)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = np.stack([np.arange(9), 2 ** 16 - np.arange(9)]).astype(np.int32)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(host(got), host(ref), rtol=0, atol=1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = layers.rope(torch.from_numpy(host(xb)).bfloat16(),
                      torch.from_numpy(pos), theta)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(host(got), host(jax_layers.rope(
        xb, jnp.asarray(pos), theta)))


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_matches(act, dtype):
    """float32 within 1e-5 x max; bf16 bit for bit (P14: each op rounded
    to bf16, gelu's constants in bf16, as the reference)."""
    cfg = jax_configs.get_smoke("qwen3_0_6b").scaled(act=act, dtype=dtype)
    jdt = jnp.dtype(dtype)
    p = jax_layers.init_mlp(jax.random.PRNGKey(0), cfg, jdt)
    tp = {k: torch.from_numpy(host(v)).to(getattr(torch, dtype))
          for k, v in p.items()}
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 5, 64)),
                    jdt)
    got = layers.mlp_forward(tp, configs.get_smoke("qwen3_0_6b").scaled(
        act=act, dtype=dtype), torch.from_numpy(host(x)).to(tp["w1"].dtype))
    ref = jax_layers.mlp_forward(p, cfg, x)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(host(got), host(ref))
    else:
        assert_close(got, ref, 1e-5, act)


@pytest.mark.parametrize("mode", ["no cache", "prefill", "prefill ring",
                                  "decode"])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "gemma2_9b"])
def test_attn_forward_matches(arch, mode):
    """The attention block at float32 with non-zero qk-norm scales: without
    a cache, a prefill into a cache (contiguous, and a ring of 5 slots
    written at pos % 5), and a decode step over a part-filled cache."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, "float32")
    jpa = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tpa = lm._index(tp["layers"], 0)["attn"]
    B, S, Sc = 2, 11, {"prefill ring": 5}.get(mode, 16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    window = 6 if arch == "gemma2_9b" else 0
    jc = tc = None
    if mode != "no cache":
        shape = (B, Sc, jcfg.n_kv_heads, jcfg.head_dim)
        jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "pos": jnp.full((B, Sc), -1, jnp.int32)}
        tc = {"k": torch.zeros(shape), "v": torch.zeros(shape),
              "pos": torch.full((B, Sc), -1, dtype=torch.int32)}
    if mode == "decode":
        # fill the first 7 slots, then decode at position 7 (row 0) and 9
        jo, jc = jax_layers.attn_forward(jpa, jcfg, jnp.asarray(x[:, :7]),
                                         jnp.asarray(pos[:, :7]),
                                         window=jnp.int32(window), cache=jc)
        layers.attn_forward(tpa, tcfg, torch.from_numpy(x[:, :7]),
                            torch.from_numpy(pos[:, :7]), window=window,
                            cache=tc)
        x, pos = x[:, 7:8], np.array([[7], [9]], np.int32)
    ref, jnc = jax_layers.attn_forward(jpa, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos),
                                       window=jnp.int32(window), cache=jc)
    got, tnc = layers.attn_forward(tpa, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(pos), window=window,
                                   cache=tc)
    assert_close(got, ref, F32, mode)
    if mode == "no cache":
        assert tnc is None
    else:
        assert_cache({"attn": tnc}, {"attn": jnc}, F32)


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_lm_matches_the_reference(arch, dtype, monkeypatch):
    """``forward`` (logits and ``aux``), ``prefill`` (last logits and the
    cache) and a decode step, at float32 and at the config's own bf16; on
    the MoE configs every MoE call's routing too.  The encoder-decoder:
    ``decode_train``, ``prefill`` and a decode step."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, dtype)
    B, S = 2, 24
    toks, pe = inputs(jcfg, B, S)
    tol = TOL[dtype]
    if tcfg.family == "encdec":
        encdec_matches(jcfg, jp, tcfg, tp, pe, toks, 40, tol)
        return
    routes = Routings().install(monkeypatch)
    flipped = set()

    def rows():
        """The rows no routing flip has reached yet."""
        flipped.update(routes.flipped_rows(B, TIE[dtype], flipped))
        return [b for b in range(B) if b not in flipped]

    ref, raux = jax_lm.forward(jp, jcfg, jnp.asarray(toks), jx(pe))
    got, aux = lm.forward(tp, tcfg, toks, pe, device=CPU)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert got.shape[-1] == tcfg.padded_vocab
    if tcfg.n_experts:
        assert float(aux) > 0
        assert abs(float(aux) - float(raux)) <= \
            (1e-6 if dtype == "float32" else BF16) * float(raux)
    else:
        assert float(aux) == float(raux) == 0.0
    assert_close(got, ref, tol, "forward", rows=rows())

    flipped.clear()
    jc = jax_lm.init_cache(jcfg, B, 40)
    tc = lm.init_cache(tcfg, B, 40, device=CPU)
    ref, jc = jax_lm.prefill(jp, jcfg, jnp.asarray(toks[:, :-1]), jc, jx(pe))
    got, tc = lm.prefill(tp, tcfg, toks[:, :-1], tc, pe, device=CPU)
    keep = rows()
    assert_close(got, ref, tol, "prefill", rows=keep)
    assert_cache(tc, jc, tol, rows=keep)

    total = S - 1 + (jcfg.vision_len if jcfg.family == "vlm" else 0)
    pos = np.full((B,), total, np.int32)
    ref, jc = jax_lm.decode_step(jp, jcfg, jnp.asarray(toks[:, -1:]),
                                 jnp.asarray(pos), jc)
    got, tc = lm.decode_step(tp, tcfg, toks[:, -1:], pos, tc, device=CPU)
    keep = rows()
    assert_close(got, ref, tol, "decode", rows=keep)
    assert_cache(tc, jc, tol, rows=keep)
    assert routes.checked == (3 * tcfg.n_layers if tcfg.n_experts else 0)
    if dtype == "float32":
        assert not flipped


def left_padded(cfg, lens, seed: int = 0, S: int | None = None
                ) -> np.ndarray:
    """Prompts of the given lengths left-padded with token 0 to the
    longest (or to ``S``), as ``examples/serve_balanced.py`` lays them
    out."""
    rng = np.random.default_rng(seed)
    S = max(lens) if S is None else S
    toks = np.zeros((len(lens), S), np.int32)
    for i, n in enumerate(lens):
        toks[i, S - n:] = rng.integers(0, cfg.vocab_size, n)
    return toks


def serve(prefill, decode, toks, ctx: int, steps: int, chosen=None):
    """Prefill, then greedy decode: the logits of each call and the tokens
    chosen.  Given ``chosen`` (the reference's), those tokens are fed
    instead, so a near tie in the argmax cannot send the packages down
    different sequences."""
    B, S = toks.shape
    logits, cache = prefill(toks, ctx)
    out, picked = [logits], []
    for t in range(steps):
        tok = np.asarray(host(logits)[:, -1].argmax(-1), np.int32)[:, None]
        if chosen is not None:
            tok = chosen[t]
        picked.append(tok)
        logits, cache = decode(tok, np.full((B,), S + t, np.int32), cache)
        out.append(logits)
    return out, picked


def serve_both(jcfg, jp, tcfg, tp, toks, ctx, steps):
    """The same prompts served by the reference and by the port."""
    ref, picked = serve(
        lambda t, c: jax_lm.prefill(jp, jcfg, jnp.asarray(t),
                                    jax_lm.init_cache(jcfg, len(t), c)),
        lambda t, p, c: jax_lm.decode_step(jp, jcfg, jnp.asarray(t),
                                           jnp.asarray(p), c),
        toks, ctx, steps)
    got, _ = serve(
        lambda t, c: lm.prefill(tp, tcfg, t,
                                lm.init_cache(tcfg, len(t), c, device=CPU),
                                device=CPU),
        lambda t, p, c: lm.decode_step(tp, tcfg, t, p, c, device=CPU),
        toks, ctx, steps, chosen=picked)
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_left_padded_batch_matches_the_reference(dtype):
    """A left-padded batch (pads at positions 0.., attended like any
    token) gives the reference's prefill and greedy decode logits; and
    the padded row differs from the same prompt alone, by the same amount
    in both packages."""
    (jcfg, jp), (tcfg, tp) = both_params("qwen3_0_6b", dtype)
    lens = [13, 4, 9]
    toks = left_padded(jcfg, lens)
    got, ref = serve_both(jcfg, jp, tcfg, tp, toks, 13 + 6, 5)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, TOL[dtype], f"call {i}")
    if dtype == "bfloat16":
        return
    alone = toks[1:2, 13 - 4:]
    r_alone, _ = jax_lm.prefill(jp, jcfg, jnp.asarray(alone),
                                jax_lm.init_cache(jcfg, 1, 8))
    g_alone, _ = lm.prefill(tp, tcfg, alone,
                            lm.init_cache(tcfg, 1, 8, device=CPU),
                            device=CPU)
    d_ref = host(ref[0])[1] - host(r_alone)[0]
    d_got = host(got[0])[1] - host(g_alone)[0]
    assert np.abs(d_ref).max() > 100 * F32 * np.abs(host(r_alone)).max()
    assert_close(d_got, d_ref, 1e-3, "padded row - row alone")


def test_left_padded_moe_batch_matches_the_reference(monkeypatch):
    """P15: mixtral-smoke's MoE takes B*S tokens only where moe_group (64)
    exceeds or divides them, so a batch of 4 prompts of up to 19 tokens
    (76) is refused by both packages and padded to the next length both
    take, 32 (two dispatch groups); then prefill and greedy decode (g = 4)
    give the reference's logits and routing at float32."""
    (jcfg, jp), (tcfg, tp) = both_params("mixtral_8x7b", "float32")
    lens = [19, 4, 9, 11]
    with pytest.raises(ValueError, match="moe_group 64 must divide"):
        lm.prefill(tp, tcfg, left_padded(jcfg, lens),
                   lm.init_cache(tcfg, 4, 25, device=CPU), device=CPU)
    with pytest.raises(AssertionError, match="moe_group"):
        jax_lm.prefill(jp, jcfg, jnp.asarray(left_padded(jcfg, lens)),
                       jax_lm.init_cache(jcfg, 4, 25))
    S = layers.moe_padded_len(tcfg, len(lens), max(lens))
    assert S == 32
    routes = Routings().install(monkeypatch)
    toks = left_padded(jcfg, lens, S=S)
    got, ref = serve_both(jcfg, jp, tcfg, tp, toks, S + 6, 5)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, F32, f"call {i}")
    assert not routes.flipped_rows(len(lens), TIE["float32"])
    assert routes.checked == 6 * tcfg.n_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2_1_3b", "hymba_1_5b"])
def test_left_padded_ssm_batch_matches_the_reference(arch, dtype):
    """An SSM and a hybrid batch left-padded with token 0 (the pads run
    through the scan and the conv like any token): prefill (S = 13, prime
    and above the smoke's ``ssm_chunk`` of 8, so chunks of 1) and greedy
    decode steps (the recurrent step) give the reference's logits; so
    does a one-token prompt, which prefills through the recurrent step."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, dtype)
    toks = left_padded(jcfg, [13, 4, 9])
    for prompt in (toks, toks[:, -1:]):
        got, ref = serve_both(jcfg, jp, tcfg, tp, prompt, 13 + 6, 5)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, TOL[dtype], f"S={prompt.shape[1]} call {i}")


@pytest.mark.parametrize("arch", PORTED)
def test_seeded_init_keeps_its_draws(arch):
    """``init_params`` writes each layer's leaves into the stacked tensors
    as it draws them: the same parameters, bit for bit, as drawing every
    layer on its own (``init_layer``) in the same order and stacking, for
    every smoke config and Qwen3-0.6B at full width (cut to 2 layers)."""
    for cfg in (configs.get_smoke(arch),) + (
            (configs.get(arch).scaled(n_layers=2),)
            if arch == "qwen3_0_6b" else ()):
        got = port_init(cfg)(torch.Generator().manual_seed(3), cfg,
                             device=CPU)
        gen = torch.Generator().manual_seed(3)
        dt = got["embed"].dtype
        V, d = cfg.padded_vocab, cfg.d_model

        def normal(rows, std):
            return (layers.normal(gen, (rows, d), CPU) * std).to(dt)

        def stack(init, n):
            per_layer = [init(gen, cfg, CPU) for _ in range(n)]
            return jax.tree.map(lambda *x: torch.stack(x), *per_layer)

        if cfg.family == "encdec":
            want = {"enc_pos": normal(cfg.encoder_len, 0.01),
                    "enc_layers": stack(encdec.init_enc_layer,
                                        cfg.encoder_layers),
                    "embed": normal(V, 0.02), "dec_pos": normal(4096, 0.01),
                    "dec_layers": stack(encdec.init_dec_layer,
                                        cfg.n_layers)}
            unseeded = 2                                # enc_ln, ln_f
        else:
            want = {"embed": normal(V, 0.02),
                    "layers": stack(lm.init_layer, cfg.n_layers)}
            if not cfg.tie_embeddings:
                want["head"] = (layers.normal(gen, (d, V), CPU)
                                * 0.02).to(dt)
            unseeded = 1                                # ln_f
        flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        for k, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            assert flat[k].dtype == w.dtype
            assert torch.equal(flat[k], w), jax.tree_util.keystr(k)
        assert len(flat) == len(jax.tree_util.tree_leaves(want)) + unseeded


@pytest.mark.parametrize("S", [16, 13, "hybrid"])
def test_bounded_ring_cache_matches_the_reference(S):
    """qwen3-smoke with an 8-token window keeps 8 slots: a prefill of 16
    (written contiguously, 16 % 8 == 0) or 13 (at pos % 8), then decode
    steps past the ring's end, each wrapping onto the oldest slot.  The
    hybrid (hymba-smoke, its own window of 8): a prefill of 13, then ten
    decode steps, attention over the ring and the SSM's recurrent state."""
    arch, kw = ("hymba_1_5b", {}) if S == "hybrid" else (
        "qwen3_0_6b", {"sliding_window": 8})
    S = 13 if S == "hybrid" else S
    (jcfg, jp), (tcfg, tp) = both_params(arch, "float32", **kw)
    assert tcfg.bounded_kv and tcfg.sliding_window == 8
    toks, _ = inputs(jcfg, 2, S)
    got, ref = serve_both(jcfg, jp, tcfg, tp, toks, 64, 10)
    assert lm.init_cache(tcfg, 2, 64, device=CPU)["attn"]["k"].shape[2] == 8
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close(g, r, F32, f"call {i}")


def test_loss_is_not_ported(monkeypatch):
    """Every family builds the reference's five functions.  ``loss`` was a
    stub that raised until training was ported; it is now the training
    objective (``tests/test_torch_loss.py`` holds it against the
    reference): on the CPU it returns a float32 loss and the reference's
    metrics, and without ``device=`` it needs the card."""
    for arch in ("qwen3_0_6b", "mamba2_1_3b", "hymba_1_5b",
                 "whisper_large_v3"):
        cfg = configs.get_smoke(arch)
        model = api.build(cfg)
        assert [f.name for f in dataclasses.fields(model)] == [
            f.name for f in dataclasses.fields(jax_api.Model)]
        params = model.init(torch.Generator().manual_seed(0), device=CPU)
        toks = np.zeros((1, 6), np.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "encdec":
            batch["frames"] = np.zeros((1, cfg.encoder_len, cfg.d_model),
                                       np.float32)
        with torch.no_grad():
            loss, metrics = model.loss(params, batch, device=CPU)
        assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
        assert set(metrics) == ({"nll"} if cfg.family == "encdec"
                                else {"nll", "aux"})
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.loss(params, batch)
        monkeypatch.undo()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch, dtype):
    """``tests/test_models.py::test_decode_matches_forward`` on the port,
    through ``api.build`` and the port's own seeded init: prefill on S-1
    tokens and one decode step give ``forward``'s last logits (the
    reference's rtol = atol = 0.15 at bf16; 1e-4 x max at float32)."""
    cfg = configs.get_smoke(arch).scaled(dtype=dtype)
    model = api.build(cfg)
    params = model.init(torch.Generator().manual_seed(1), device=CPU)
    B, S = 2, 24
    toks, pe = inputs(cfg, B, S, seed=5)
    pre = {"tokens": toks[:, :S - 1]}
    if cfg.family == "encdec":
        full = encdec.decode_train(params, cfg, pe, toks, device=CPU)
        pre["frames"] = pe
    else:
        full, _ = lm.forward(params, cfg, toks, pe, device=CPU)
        if pe is not None:
            pre["prefix_embeds"] = pe
    cache = model.init_cache(B, 64, device=CPU)
    _, cache = model.prefill(params, pre, cache, device=CPU)
    total = S - 1 + (cfg.vision_len if cfg.family == "vlm" else 0)
    logits, _ = model.decode(params, toks[:, S - 1:S],
                             np.full((B,), total, np.int32), cache,
                             device=CPU)
    if dtype == "bfloat16":
        np.testing.assert_allclose(host(logits[:, 0]), host(full[:, -1]),
                                   rtol=0.15, atol=0.15)
    else:
        assert_close(logits[:, 0], full[:, -1], F32, "decode vs forward")
