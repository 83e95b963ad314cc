"""The port's encoder-decoder (``models/encdec.py``) against the JAX package,
on the CPU.

The same NumPy inputs (stub frames and tokens) and the reference's own
parameters (``repro.models.encdec.init_params``, every norm scale set to
non-zero random values on both sides, converted by
``lm.params_from_numpy``) go through both packages on the whisper smoke
config: the encoder, the teacher-forced decoder, prefill into a cache
(longer and shorter than the prompt) and decode steps, past the 4096
learned decoder positions too.

Tolerances: float32 within ``F32`` = 1e-4 x max |reference| on logits,
encoder states and every cache entry, the cache positions equal; bf16
within ``BF16`` = 4e-2 x (the norms' float32 sums, see
``test_torch_models.py``).  The non-causal chunked attention over 1500
keys (whisper's frames, a multiple of neither chunk) within 1e-5 x at
float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch.models import encdec, layers

from _torch_models_parity import (CPU, F32, TOL, assert_cache, assert_close,
                                  both_params, encdec_matches, inputs)

ARCH = "whisper_large_v3"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype):
    """The bidirectional encoder: frames cast to the model dtype, plus
    ``enc_pos``, through the layers and ``enc_ln``."""
    (jcfg, jp), (tcfg, tp) = both_params(ARCH, dtype)
    _, frames = inputs(jcfg, 2, 1)
    ref = jax_encdec.encode(jp, jcfg, jnp.asarray(frames))
    got = encdec.encode(tp, tcfg, frames, device=CPU)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, tcfg.encoder_len, tcfg.d_model)
    assert_close(got, ref, TOL[dtype], "encode")


@pytest.mark.parametrize("S,ctx", [(13, 32), (13, 8), (13, 6), (2, 32)])
def test_prefill_and_decode_match(S, ctx):
    """``decode_train``, ``prefill`` of S-1 tokens and a decode step into a
    self-attention cache of ``ctx`` slots: longer than the prompt
    (contiguous), shorter (written at pos % ctx: 12 tokens into 8 slots,
    and into 6, which the port writes contiguously and the reference by
    scatter, to the same slots), and a one-token prompt."""
    (jcfg, jp), (tcfg, tp) = both_params(ARCH, "float32", seed=S + ctx)
    toks, frames = inputs(jcfg, 2, S, seed=ctx)
    encdec_matches(jcfg, jp, tcfg, tp, frames, toks, ctx, F32)


def test_decode_past_the_learned_positions():
    """Decoder positions wrap at 4096: after a prefill of 5 tokens, a decode
    step at position 4100 with a cache of 4104 slots reads row 4 of
    ``dec_pos`` and attends over the 5 cached tokens and itself."""
    (jcfg, jp), (tcfg, tp) = both_params(ARCH, "float32", seed=3)
    toks, frames = inputs(jcfg, 2, 6, seed=3)
    encdec_matches(jcfg, jp, tcfg, tp, frames, toks, 4104, F32, pos=4100)
    # the step reads row 4 of dec_pos: zeroing it moves the logits,
    # zeroing row 5 leaves them as they were
    tc = encdec.init_cache(tcfg, 2, 4104, device=CPU)
    encdec.prefill(tp, tcfg, frames, toks[:, :-1], tc, device=CPU)
    kept = {k: v.clone() for k, v in tc["self"].items()}
    pos = np.full((2,), 4100, np.int32)
    logits = {}
    for row in (None, 4, 5):
        p = dict(tp, dec_pos=tp["dec_pos"].clone())
        if row is not None:
            p["dec_pos"][row] = 0
        for k, v in kept.items():
            tc["self"][k].copy_(v)
        logits[row], _ = encdec.decode_step(p, tcfg, toks[:, -1:], pos, tc,
                                            device=CPU)
    assert float((logits[4] - logits[None]).abs().max()) > 1e-3
    assert torch.equal(logits[5], logits[None])


@pytest.mark.parametrize("S,ctx", [(13, 8), (12, 6)])
def test_self_cache_write_is_the_reference_rule(S, ctx):
    """``layers.write_cache``, which the port's decoder uses, against the
    reference's own rule (``encdec.py:115-127``) on a cache shorter than the
    prompt: the same slots hold the same entries and positions."""
    rng = np.random.default_rng(S)
    B, H, dh = 2, 2, 4
    k = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    W = min(S, ctx)
    slots = pos[:, S - W:] % ctx
    want_k = np.zeros((B, ctx, H, dh), np.float32)
    want_pos = np.full((B, ctx), -1, np.int32)
    for b in range(B):
        want_k[b, slots[b]] = k[b, S - W:]
        want_pos[b, slots[b]] = pos[b, S - W:]
    cache = {"k": torch.zeros((B, ctx, H, dh)),
             "pos": torch.full((B, ctx), -1, dtype=torch.int32)}
    layers.write_cache(cache, {"k": torch.from_numpy(k)},
                       torch.from_numpy(np.ascontiguousarray(pos)))
    np.testing.assert_array_equal(cache["k"].numpy(), want_k)
    np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)


def test_bidirectional_attention_over_1500_keys():
    """``chunked_attention`` with ``causal=False`` and no window on 1500
    queries and keys, whisper's chunks (512 queries, 1024 keys), neither a
    divisor of 1500: the padded keys are masked, every real one attended."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 1500, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(1500, dtype=np.int32)[None]
    kw = dict(causal=False, softcap=0.0, scale=8 ** -0.5, q_chunk=512,
              kv_chunk=1024)
    ref = jax_layers.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)),
        window=jnp.int32(0), **kw)
    got = layers.chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos, pos)), window=0, **kw)
    assert_close(got, ref, 1e-5, "attention")
    s = np.einsum("qhd,khd->hqk", q[0], k[0]) * 8 ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), v[0])
    assert_close(got[0], dense, 1e-5, "dense softmax")


def test_cache_layout_is_the_reference_layout():
    (jcfg, _), (tcfg, _) = both_params(ARCH, "bfloat16")
    jc = jax_encdec.init_cache(jcfg, 3, 10)
    tc = encdec.init_cache(tcfg, 3, 10, device=CPU)
    assert_cache(tc, jc, 0.0)
    for a, b in ((tc["self"]["k"], jc["self"]["k"]), (tc["enc"], jc["enc"]),
                 (tc["self"]["pos"], jc["self"]["pos"])):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)
