"""The port's Mamba2 SSD block (``models/ssm.py``) against the JAX package,
on the CPU.

The same NumPy inputs, and the reference's own ``init_ssm`` parameters
with ``A_log``, ``D``, ``dt_bias`` and ``out_norm`` set to seeded
non-trivial values (at their initial 0, 1, 0, A = -1 would hide a sign or
an ``exp`` error), go through both packages on the mamba2 smoke config;
the whole models are held in ``test_torch_models.py``.

Tolerances:

- ``_segsum`` and ``cumsum``: bit for bit (the port adds in XLA's CPU
  order, ``ssm.cumsum``).
- ``exp``: the port calls ``torch.exp``.  It gives 0 at -inf as XLA does;
  where XLA flushes a result below 2**-126 to 0, torch keeps a denormal,
  so the difference there is below 2**-126 absolute; elsewhere within 1
  ulp.  ``softplus``: within 4 ulps (relative 2**-21) of
  ``jax.nn.softplus`` on [-100, 100], and below 2**-126 apart where XLA
  flushes a denormal result (x below about -87.3); neither ``F.softplus`` nor
  ``torch.logaddexp`` is bit-equal (XLA's ``log1p`` and ``exp`` differ by
  an ulp), and the port takes ``logaddexp``, the reference's form.
- ``_causal_conv``: bit for bit at bf16 (each tap's product and sum
  rounded to bf16, in order) and on the new tail; at float32 within 1e-6 x
  max |reference| (XLA fuses some of the taps' multiply-adds: about a
  third of the outputs differ in the last bit or two).
- ``_ssd_chunked`` and ``ssm_forward``: float32 within ``F32`` = 1e-4 x
  max |reference| on the output, the state and the conv tail; bf16 (the
  activations, the compute dtype, or both) within ``BF16`` = 4e-2 x.
  Against the naive step-by-step recurrence: 2e-4 x at float32 compute,
  as ``tests/test_models.py::test_ssd_matches_naive_recurrence``; 4e-2 x
  at bf16 compute, whose decays and chunk states are rounded to bf16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import ssm as jax_ssm
from repro_torch import configs
from repro_torch.models import ssm

from _torch_models_parity import BF16, F32, assert_close, host

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "mamba2_1_3b"


def t(x, dtype=None):
    """A NumPy or JAX array as a tensor of its own dtype (or ``dtype``)."""
    dt = TORCH[str(jnp.asarray(x).dtype)] if dtype is None else TORCH[dtype]
    return torch.from_numpy(host(x)).to(dt)


def ssm_case(dtype: str, compute: str = "float32", seed: int = 0):
    """(reference config, params), (port config, params): the reference's
    ``init_ssm`` with ``A_log``, ``D``, ``dt_bias`` and ``out_norm`` drawn
    from a seed."""
    kw = dict(dtype=dtype, ssm_compute_dtype=compute)
    jcfg = jax_configs.get_smoke(ARCH).scaled(**kw)
    tcfg = configs.get_smoke(ARCH).scaled(**kw)
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    rng = np.random.default_rng(seed)
    H = jcfg.ssm_heads
    jp["A_log"] = jnp.asarray(rng.standard_normal(H) * 0.5, jnp.float32)
    jp["D"] = jnp.asarray(rng.standard_normal(H), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.standard_normal(H) * 0.5, jnp.float32)
    jp["out_norm"] = jnp.asarray(rng.standard_normal(jcfg.d_inner) * 0.5,
                                 jnp.dtype(dtype))
    return (jcfg, jp), (tcfg, {k: t(v) for k, v in jp.items()})


# ---------------------------------------------------------------------------
# the scan's arithmetic


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 17, 33, 96, 128, 257, 4100])
def test_cumsum_is_the_reference_bit_for_bit(n):
    """XLA's CPU cumsum: sequential in blocks of 16, block offsets by the
    same scan (recursively past 256 entries)."""
    x = (np.random.default_rng(n).standard_normal((3, 5, n)) * 0.3).astype(
        np.float32)
    ref = np.asarray(jax.jit(functools.partial(jnp.cumsum, axis=-1))(x))
    got = ssm.cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n", [1, 4, 8, 17, 96, 128])
def test_segsum_is_the_reference_bit_for_bit(n):
    """Negative decays laid out as the scan's (b, H, nc, l): the segment
    sums, -inf above the diagonal, bit for bit."""
    x = -np.abs(np.random.default_rng(n).standard_normal(
        (2, 3, 2, n))).astype(np.float32) * 0.3
    ref = np.asarray(jax.jit(jax_ssm._segsum)(x))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    assert np.isneginf(got).sum() == 12 * n * (n - 1) // 2
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_exp_of_the_scan_is_the_reference_exp():
    """The SSM's ``torch.exp`` against XLA's: 0 at -inf (the segment sums'
    upper triangle), below 2**-126 apart where XLA flushes denormals, and
    within 1 ulp elsewhere."""
    x = np.concatenate([np.linspace(-110, 10, 1_200_001, dtype=np.float32),
                        np.array([-np.inf, -87.3365, -87.34, -103.9],
                                 np.float32)])
    ref = np.asarray(jax.jit(jnp.exp)(x))
    got = torch.exp(torch.from_numpy(x)).numpy()
    assert got[-4] == ref[-4] == 0.0
    flushed = ref == 0
    assert flushed.sum() > 200_000
    assert np.abs(got[flushed]).max() < 2.0 ** -126
    assert (np.abs(got - ref)[~flushed] <= np.spacing(ref[~flushed])).all()


def test_softplus_is_the_reference_softplus():
    x = np.linspace(-100, 100, 2_000_001, dtype=np.float32)
    ref = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -21, atol=2.0 ** -126)
    assert ssm.softplus(torch.tensor([-np.inf, np.inf])).tolist() == [
        0.0, np.inf]


# ---------------------------------------------------------------------------
# the chunked scan and the conv


def naive(xdt, dA, Bm, Cm, h0):
    """The step-by-step recurrence in float64 on the scan's inputs."""
    xdt, dA, Bm, Cm = (np.asarray(host(a), np.float64)
                       for a in (xdt, dA, Bm, Cm))
    h = np.asarray(host(h0), np.float64)
    ys = []
    for s in range(xdt.shape[1]):
        h = h * np.exp(dA[:, s])[..., None, None] + np.einsum(
            "bn,bhp->bhpn", Bm[:, s], xdt[:, s])
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, s], h))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_ssd_chunked_matches(chunk, with_h0, compute):
    """The reference's ``_ssd_chunked`` and the naive recurrence, at 16
    steps in chunks of 1, 4 and 8, from zero or a given state, with the
    scan's operands and intermediates in float32 or bf16."""
    rng = np.random.default_rng(chunk)
    b, S, H, P, N = 2, 16, 3, 4, 8
    cdt = jnp.dtype(compute)
    xdt = jnp.asarray(rng.standard_normal((b, S, H, P)) * 0.3, cdt)
    dA = jnp.asarray(-np.abs(rng.standard_normal((b, S, H))) * 0.2,
                     jnp.float32)
    Bm = jnp.asarray(rng.standard_normal((b, S, N)) * 0.4, cdt)
    Cm = jnp.asarray(rng.standard_normal((b, S, N)) * 0.4, cdt)
    h0 = jnp.asarray(rng.standard_normal((b, H, P, N)), jnp.float32)
    y_ref, h_ref = jax.jit(jax_ssm._ssd_chunked, static_argnums=4)(
        xdt, dA, Bm, Cm, chunk, h0 if with_h0 else None)
    y, h = ssm._ssd_chunked(t(xdt), t(dA), t(Bm), t(Cm), chunk,
                            h0=t(h0) if with_h0 else None)
    assert y.dtype == h.dtype == torch.float32
    tol = F32 if compute == "float32" else BF16
    assert_close(y, y_ref, tol, "y")
    assert_close(h, h_ref, tol, "final state")
    y_n, h_n = naive(xdt, dA, Bm, Cm, h0 if with_h0 else np.zeros_like(h0))
    tol = 2e-4 if compute == "float32" else BF16
    assert_close(y, y_n, tol, "y vs the recurrence")
    assert_close(h, h_n, tol, "state vs the recurrence")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,tail", [(1, True), (2, True), (13, True),
                                    (2, False), (13, False)])
def test_causal_conv_matches(S, tail, dtype):
    """The depthwise conv (K = 4) and its new tail: without a tail, with
    one, and at S < K-1, where the new tail keeps rows of the old one."""
    rng = np.random.default_rng(S)
    jdt = jnp.dtype(dtype)
    D, K = 12, 4
    u = jnp.asarray(rng.standard_normal((2, S, D)), jdt)
    w = jnp.asarray(rng.standard_normal((K, D)), jdt)
    tl = jnp.asarray(rng.standard_normal((2, K - 1, D)), jdt) if tail \
        else None
    y_ref, tail_ref = jax.jit(jax_ssm._causal_conv)(u, w, tl)
    y, new_tail = ssm._causal_conv(t(u), t(w), None if tl is None else t(tl))
    assert y.dtype == new_tail.dtype == TORCH[dtype]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(host(y), host(y_ref))
    else:
        assert_close(y, y_ref, 1e-6, "conv")
    np.testing.assert_array_equal(host(new_tail), host(tail_ref))
    if tail and S < K - 1:
        np.testing.assert_array_equal(host(new_tail)[:, :K - 1 - S],
                                      host(tl)[:, S:])


# ---------------------------------------------------------------------------
# the block


@pytest.mark.parametrize("S,chunk", [(1, 1), (2, 2), (13, 1), (16, 8),
                                     (24, 8), (19, 1)])
def test_chunk_is_the_largest_divisor(S, chunk, monkeypatch):
    """The scan's chunk is the largest divisor of S not above
    ``ssm_chunk`` (8 in the smoke config): a prime S above it runs in
    chunks of 1.  At mamba2-1.3b's ``ssm_chunk`` of 128, the served groups'
    S = 192 runs in chunks of 96 and S = 19 in one chunk of 19."""
    (_, _), (cfg, p) = ssm_case("float32")
    seen, core = [], ssm._ssd_chunked
    monkeypatch.setattr(ssm, "_ssd_chunked", lambda *a, **kw: seen.append(
        a[4]) or core(*a, **kw))
    x = torch.zeros((1, S, cfg.d_model))
    ssm.ssm_forward(p, cfg, x)
    assert seen == [chunk]
    full = configs.get(ARCH)
    sizes = [max(c for c in range(1, min(full.ssm_chunk, n) + 1)
                 if n % c == 0) for n in (192, 19)]
    assert sizes == [96, 19]


def ref_cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    H, P, N = cfg.ssm_heads, cfg.d_inner // cfg.ssm_heads, cfg.ssm_state
    return {"state": jnp.asarray(rng.standard_normal((B, H, P, N)) * 0.5,
                                 jnp.float32),
            "conv": jnp.asarray(rng.standard_normal(
                (B, cfg.conv_kernel - 1, cfg.d_inner + 2 * N)),
                jnp.dtype(cfg.dtype))}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 13, 16, 24])
def test_ssm_forward_matches(S, dtype, compute):
    """``ssm_forward`` without a cache (the chunked scan from zero) and with
    one (from a non-zero state and conv tail: the recurrent step at S = 1,
    else the chunked scan), at float32 and bf16 activations and compute
    dtypes: the output, the state and the conv tail, the cache written in
    place."""
    (jcfg, jp), (tcfg, tp) = ssm_case(dtype, compute)
    B = 2
    tol = F32 if dtype == compute == "float32" else BF16
    x = jnp.asarray(np.random.default_rng(S).standard_normal(
        (B, S, jcfg.d_model)), jnp.dtype(dtype))
    fwd = jax.jit(functools.partial(jax_ssm.ssm_forward, cfg=jcfg))
    ref, rc = fwd(jp, x=x)
    got, gc = ssm.ssm_forward(tp, tcfg, t(x))
    assert got.dtype == TORCH[dtype] and gc["state"].dtype == torch.float32
    assert_close(got, ref, tol, "out, no cache")
    assert_close(gc["state"], rc["state"], tol, "state, no cache")
    assert_close(gc["conv"], rc["conv"], tol, "conv tail, no cache")

    jc = ref_cache(jcfg, B, S)
    tc = {k: t(v) for k, v in jc.items()}
    ref, rc = fwd(jp, x=x, cache=jc)
    got, gc = ssm.ssm_forward(tp, tcfg, t(x), cache=tc)
    assert gc is tc
    assert_close(got, ref, tol, "out, cache")
    assert_close(tc["state"], rc["state"], tol, "state, cache")
    assert_close(tc["conv"], rc["conv"], tol, "conv tail, cache")
