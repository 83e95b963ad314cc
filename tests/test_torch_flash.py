"""K5 parity: the port's flash attention (``repro_torch.kernels.flash``)
and the model layer's chunked attention (``repro_torch.models.layers``)
against the JAX package's, on the CPU.  The same NumPy inputs go to both.

On the CPU the port's wrapper runs its plain version; the JAX side runs
its Pallas kernel in interpret mode, as ``tests/test_flash.py`` does, so
these tests hold the port's plain version to the TPU kernel (the CUDA
kernel against the plain version is in ``test_torch_card.py``).

Tolerances, all compared in float32:
- port vs the Pallas kernel: ``tests/test_flash.py``'s own, 2e-5 for
  float32 and 2e-2 for bfloat16 (the kernel sums in tiles with an online
  softmax, the plain version densely), and 5e-3 for float16, about two
  float16 ulps at the outputs' magnitude (the reference's tests take no
  float16), at d <= 256 and at the wide route's widths;
- plain version vs plain version: 1e-6 (the same dense formula; only the
  einsums' summation order differs), at half the default scale, so that
  the explicit argument matters and the logits stay of order 1 (exp
  amplifies the einsums' rounding of larger logits: scale 0.3 at d=128
  gives 3.1e-6);
- chunked attention JAX vs port: 1e-5 (the same chunked online softmax;
  the einsums' summation order differs);
- port kernel entry vs port chunked attention: 3e-5, the JAX test's own;
- the float32 kernel's number design (3xTF32, emulated here) vs the plain
  version: ``tests/test_flash.py``'s 2e-5 and a relative L2 of 1e-5, the
  limits ``chip_smoke.py`` holds the kernel to on the card; one TF32 pass
  must exceed that relative L2 at d=128 (the negative control);
- the 16-bit kernels' number design (float32 scores, p rounded to the
  input's type before P V, emulated here) vs the plain version: 5e-3 and
  a relative L2 of 2.5e-3 for float16, 2e-2 and 1e-2 for bfloat16, the
  limits ``chip_smoke.py`` holds the kernels to.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CLUSTER_SHARE, FLASH_CASES, FLASH_REL_L2, FLASH_TOL,
                           WIDE_DIMS, cluster_shares, qkv)
from repro.kernels.flash import ops as jax_flash
from repro.kernels.flash.ref import attention_ref as jax_attention_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import _build
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_matches_jax_pallas(B, Sq, Skv, H, d, causal, window,
                                      softcap, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = qkv(B, Sq, Skv, H, d)
    want = jax_flash.attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), causal=causal,
                               window=window, softcap=softcap,
                               use_pallas=True, interpret=True)
    before = dict(_build.launches)
    got = flash_ops.attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)),
                              causal=causal, window=window, softcap=softcap)
    assert dict(_build.launches) == before   # the CPU runs no kernel
    assert got.dtype == tdt and got.shape == (B, Sq, H, d)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


#: the wide route's cases (d > 256): causal, a window, the softcap, and
#: ragged cross-attention (Sq != Skv, neither a multiple of a tile)
WIDE_CASES = [(1, 70, 70, 2, d, True, 0, 0.0) for d in WIDE_DIMS] + [
    (1, 96, 96, 1, 384, True, 24, 0.0),
    (1, 80, 80, 2, 576, True, 0, 50.0),
    (1, 37, 53, 2, 257, False, 0, 0.0),
    (2, 45, 130, 1, 576, False, 0, 30.0),
    (1, 96, 96, 1, 640, True, 24, 0.0),
    (1, 80, 80, 2, 1024, True, 0, 50.0),
    (2, 45, 130, 1, 1030, False, 0, 30.0),
]
#: the cluster route's cases (d > 576)
CLUSTER_CASES = [c for c in WIDE_CASES if c[4] > flash_ops.WIDE_MAXD]


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap", WIDE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wide_attention_matches_jax_pallas(B, Sq, Skv, H, d, causal, window,
                                           softcap, dtype):
    """Head dims past 256 (the wide route on the card) against the Pallas
    kernel in interpret mode, which takes any d."""
    test_attention_matches_jax_pallas(B, Sq, Skv, H, d, causal, window,
                                      softcap, dtype)


#: the realigned wide route's cases (d % 8 != 0, padded to 304 and 576)
PADDED_CASES = [c for d in (300, 575) for c in (
    (1, 70, 70, 2, d, True, 0, 0.0), (2, 45, 130, 1, d, False, 0, 30.0),
    (1, 96, 96, 1, d, True, 24, 50.0))]


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap", PADDED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_padded_wide_attention_matches_jax_pallas(B, Sq, Skv, H, d, causal,
                                                  window, softcap, dtype):
    """What the card computes on the realigned route: q, k and v padded
    with zero columns to a multiple of 8 (``ops.pad8``), attention over the
    padded width at the real d's scale, the output cut back to d
    (``ops.unpad8``); here the plain versions of each, against the Pallas
    kernel in interpret mode on the unpadded inputs."""
    jdt, tdt = DTYPES[dtype]
    q, k, v = qkv(B, Sq, Skv, H, d)
    want = jax_flash.attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), causal=causal,
                               window=window, softcap=softcap,
                               use_pallas=True, interpret=True)
    qf, kf, vf = (flash_ops.pad8(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(B * H, -1, d))).to(tdt))
        for x in (q, k, v))
    assert qf.shape[-1] == d + -d % 8 and not qf[..., d:].any()
    of = flash_ops.flash_attention(qf, kf, vf, causal=causal, window=window,
                                   softcap=softcap, scale=d ** -0.5)
    got = flash_ops.unpad8(of, d).reshape(B, H, Sq, d).transpose(1, 2)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap", FLASH_CASES)
def test_attention_ref_matches_jax(B, Sq, Skv, H, d, causal, window,
                                   softcap):
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(B * H, -1, d)
               for x in qkv(B, Sq, Skv, H, d, seed=1))
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=0.5 * d ** -0.5)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# (B, Sq, Skv, H, Hkv, dk, dv, causal, window, softcap, q_chunk, kv_chunk,
#  band_window, invalid kv slots)
CHUNKED = [
    (2, 40, 40, 3, 3, 16, 16, c, w, sc, 16, 16, 0, False)
    for c in (True, False) for w in (0, 8) for sc in (0.0, 50.0)
] + [
    (2, 40, 40, 3, 3, 16, 16, True, 8, 0.0, 16, 16, 0, True),    # -1 slots
    (2, 48, 48, 2, 2, 16, 16, False, 0, 0.0, 16, 16, 0, True),
    (1, 64, 64, 2, 2, 16, 16, True, 8, 50.0, 16, 8, 8, False),   # band
    (2, 40, 40, 4, 1, 24, 16, True, 0, 0.0, 16, 16, 0, False),   # MQA
    (2, 37, 53, 2, 2, 16, 16, False, 0, 0.0, 16, 12, 0, False),  # ragged
    (1, 37, 53, 2, 2, 32, 32, True, 5, 30.0, 8, 16, 0, True),
]


def _positions(B, Sq, Skv, invalid, seed):
    rng = np.random.default_rng(seed)
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv), (B, Sq)).copy()
    kv_pos = np.broadcast_to(np.arange(Skv), (B, Skv)).copy()
    if invalid:
        kv_pos[rng.random((B, Skv)) < 0.25] = -1
    return q_pos.astype(np.int32), kv_pos.astype(np.int32)


@pytest.mark.parametrize(
    "B,Sq,Skv,H,Hkv,dk,dv,causal,window,softcap,qc,kc,band,invalid",
    CHUNKED)
def test_chunked_attention_matches_jax(B, Sq, Skv, H, Hkv, dk, dv, causal,
                                       window, softcap, qc, kc, band,
                                       invalid):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, Sq, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, dk)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, dv)).astype(np.float32)
    q_pos, kv_pos = _positions(B, Sq, Skv, invalid, seed=3)
    kw = dict(causal=causal, softcap=softcap, scale=dk ** -0.5, q_chunk=qc,
              kv_chunk=kc, band_window=band)
    want = jax_layers.chunked_attention(
        *(jnp.asarray(x) for x in (q, k, v, q_pos, kv_pos)),
        window=jnp.int32(window), **kw)
    t = [torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos)]
    got = layers.chunked_attention(*t, window=window, **kw)
    assert got.shape == (B, Sq, H, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # window as a 0-d tensor, as the reference takes a traced int32
    got_t = layers.chunked_attention(*t, window=torch.tensor(window), **kw)
    assert torch.equal(got_t, got)


@pytest.mark.parametrize("n_rep", [1, 2, 3])
def test_repeat_kv_matches_jax(n_rep):
    k = np.random.default_rng(4).standard_normal((2, 5, 3, 8)).astype(
        np.float32)
    want = np.asarray(jax_layers.repeat_kv(jnp.asarray(k), n_rep))
    got = layers.repeat_kv(torch.from_numpy(k), n_rep).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_flash_matches_model_attention():
    """The kernel's entry point agrees with the model layer's chunked
    attention (the port's twin of ``tests/test_flash.py``'s test)."""
    B, S, H, d = 2, 96, 4, 32
    q, k, v = (torch.from_numpy(x) for x in qkv(B, S, S, H, d, seed=5))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    a = layers.chunked_attention(q, k, v, pos, pos, causal=True,
                                 window=torch.tensor(0), softcap=0.0,
                                 scale=d ** -0.5, q_chunk=32, kv_chunk=32)
    b = flash_ops.attention(q, k, v, causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-5, atol=3e-5)


def test_launch_passes_floats_as_c_float(monkeypatch):
    """``_build.launch`` hands a Python float to the C entry point as a C
    float (0.0625 arrives as 0.0625, not as int 0) and ints as ints; the
    entry point here is a ctypes callback with K5's real signature."""
    name = "repro_flash_attn_f32"
    seen = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *_build._SIGNATURES[name])
    fn = proto(lambda *a: seen.append(a) or 0)

    class Lib:
        pass

    lib = Lib()
    setattr(lib, name, fn)
    monkeypatch.setattr(_build, "library", lambda: lib)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    t = torch.zeros(4)
    before = _build.launches["flash"]
    _build.launch("flash", name, t, t, t, t, 2, 3, 5, 7, 1, 4, 50.0, 0.0625)
    assert _build.launches["flash"] == before + 1
    (args,) = seen
    assert args[4:10] == (2, 3, 5, 7, 1, 4)
    assert args[10] == 50.0 and args[11] == 0.0625


@pytest.mark.parametrize("dtype,ret,key", [
    (torch.bfloat16, 0, "flash"), (torch.bfloat16, -1, "flash_general"),
    (torch.float32, 0, "flash_f32"), (torch.bfloat16, 700, None),
    (torch.bfloat16, -2, "flash_wide"), (torch.float32, -1, "flash_wide"),
    (torch.float16, 0, "flash_f16"), (torch.float16, -1, "flash_f16_general"),
    (torch.float16, -2, "flash_wide"), (torch.float16, 700, None),
    (torch.bfloat16, -3, "flash_wide_general"),
    (torch.float16, -3, "flash_wide_general"),
    (torch.float32, -2, "flash_wide_general"),
    (torch.bfloat16, -4, "flash_wide_cluster"),
    (torch.float16, -4, "flash_wide_cluster"),
    (torch.float32, -3, "flash_wide_cluster"),
    (torch.bfloat16, -5, None), (torch.float16, -5, None),
    (torch.float32, -4, None)])
def test_launch_counts_under_the_route_the_library_picks(monkeypatch, dtype,
                                                         ret, key):
    """The wrapper counts a CUDA launch under the key of the kernel the C
    entry point reports: the 16-bit entry points return 0 after the Hopper
    kernel, -1 after the general one, -2 after the wide Hopper kernel, -3
    after the general wide one and -4 after the cluster kernel, float32's
    0 after its kernel, -1 after its wide kernel, -2 after the general wide
    one and -3 after its cluster kernel.  A CUDA error (positive) or a
    code no kernel has raises and counts nothing.  The
    library here is ctypes callbacks with the real signatures; ``on_cpu``
    is told the tensors lie on the card."""
    calls = {}

    def entry(name):
        def fn(*a):
            calls[name] = a
            return ret
        return ctypes.CFUNCTYPE(ctypes.c_int, *_build._SIGNATURES[name])(fn)

    class Lib:
        pass

    lib = Lib()
    for name in ("repro_flash_attn_bf16", "repro_flash_attn_f32",
                 "repro_flash_attn_f16"):
        setattr(lib, name, entry(name))
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    q = torch.zeros(3, 5, 24, dtype=dtype)
    k = torch.zeros(3, 7, 24, dtype=dtype)
    before = dict(_build.launches)

    def run():
        flash_ops.flash_attention(q, k, k, causal=False, window=4,
                                  softcap=30.0)
    if key is None:
        with pytest.raises(RuntimeError, match="failed to launch"):
            run()
    else:
        run()
    changed = {n: c - before.get(n, 0) for n, c in _build.launches.items()
               if c != before.get(n, 0)}
    assert changed == ({} if key is None else {key: 1})
    fn = {torch.bfloat16: "repro_flash_attn_bf16",
          torch.float16: "repro_flash_attn_f16",
          torch.float32: "repro_flash_attn_f32"}[dtype]
    assert list(calls) == [fn]
    assert calls[fn][0] == q.data_ptr()
    assert calls[fn][4:11] == (3, 5, 7, 24, 0, 4, 30.0)
    assert calls[fn][11] == pytest.approx(24 ** -0.5, rel=1e-7)


# ---------------------------------------------------------------------------
# The float32 kernel's number design, emulated on the CPU.  flash.cu's
# flash_f32_kernel computes both products on the tensor cores in 3xTF32:
# each float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
# both rounded by cvt.rna (to nearest, ties away from zero, 10 mantissa
# bits), and a b is summed as lo(a) hi(b) + hi(a) lo(b), then hi(a) hi(b),
# in float32.  Key tiles as the kernel's (64 keys at d <= 64, else 32, as
# on the general wide route; flash_wide_f32_kernel takes 96), with its
# online softmax in float32.


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view of the bits: add half of the
    13 dropped bits' unit to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: 3xTF32, or one TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _partials(q, kt, blocks, mm):
    """q kt^T as flash_wide_cluster sums it: each block's partial over
    its column ranges (``blocks``: a list of ranges a block, added in
    order), the blocks' partials added in ascending rank."""
    total = None
    for ranges in blocks:
        part = None
        for c0, c1 in ranges:
            x = mm(q[..., c0:c1], kt[..., c0:c1].transpose(1, 2))
            part = x if part is None else part + x
        total = part if total is None else total + part
    return total


def _cluster_columns(d, elem_bytes):
    """flash_wide_cluster's column ranges by block at head dim d (run on
    d padded to a multiple of 8): ``cluster_shares``'s chunks; at 16
    bits each block's chunks split between its two warpgroups as
    ``hw::Split`` does (the first ceil(n / 2), then the rest)."""
    out = []
    for c0, c1 in cluster_shares(flash_ops.padded(d), elem_bytes):
        sa = c0 + (c1 - c0 + 1) // 2
        ranges = [(c0, sa), (sa, c1)] if elem_bytes == 2 else [(c0, c1)]
        out.append([(64 * a, min(64 * b, d)) for a, b in ranges])
    return out


def _attention_tf32(q, k, v, *, causal, window, softcap, passes=3,
                    BK=None, blocks=None):
    """(BH, S, d) float32 attention with the kernel's products and online
    softmax over its key tiles (``BK`` keys, by default flash_f32_kernel's
    and the general wide kernel's); with ``blocks``, S summed as the
    cluster kernel sums it (:func:`_partials`)."""
    BH, Sq, d = q.shape
    Skv = k.shape[1]
    BK = BK or (64 if d <= 64 else 32)
    scale = d ** -0.5
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, d))
    i = torch.arange(Sq)[:, None]

    def mm(a, b):
        return _mm(a, b, passes)
    for k0 in range(0, Skv, BK):
        j = torch.arange(k0, min(k0 + BK, Skv))[None, :]
        kt = k[:, k0:k0 + BK]
        s = (mm(q, kt.transpose(1, 2)) if blocks is None
             else _partials(q, kt, blocks, mm)) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        ok = torch.ones_like(s[0], dtype=torch.bool)
        if causal:
            ok &= j <= i
        if window > 0:
            ok &= i - j < window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm(p, v[:, k0:k0 + BK], passes)
        m = m_new
    return acc / l.clamp_min(1e-30)


def _fold_case(B, Sq, Skv, H, d, seed=0):
    return tuple(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(B * H, -1, d)))
        for x in qkv(B, Sq, Skv, H, d, seed))


def _rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def test_tf32_rounds_half_away_from_zero():
    """The emulation's cvt.rna: ties go away from zero on both signs, and
    the result keeps 10 mantissa bits."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      3.0, one + 3 * ulp / 2], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, 3.0, one + 2 * ulp])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    assert bool(((_tf32(r).view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((_tf32(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap",
                         FLASH_CASES + WIDE_CASES)
def test_3xtf32_design_matches_plain(B, Sq, Skv, H, d, causal, window,
                                     softcap):
    """3xTF32 products in the kernel's tiles keep the float32 contract:
    2e-5 (``tests/test_flash.py``) and relative L2 1e-5 (``chip_smoke.py``)
    against the plain version in full float32."""
    q, k, v = _fold_case(B, Sq, Skv, H, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _attention_tf32(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert _rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap", WIDE_CASES)
def test_3xtf32_design_in_wide_tiles_matches_plain(B, Sq, Skv, H, d, causal,
                                                   window, softcap):
    """The wide float32 kernel (flash_wide_f32_kernel) computes S once a
    tile of 96 keys: the same 3xTF32 products over its tiles keep the
    float32 contract."""
    q, k, v = _fold_case(B, Sq, Skv, H, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _attention_tf32(q, k, v, BK=96, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert _rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("d", [128, 256])
def test_one_tf32_pass_misses_the_float32_contract(d):
    """The negative control: the same attention with one TF32 pass a
    product (hi x hi) is further off than the relative L2 limit, so the
    test above can tell 3xTF32 from plain TF32."""
    q, k, v = _fold_case(1, 100, 100, 1, d)
    want = attention_ref(q, k, v, causal=True)
    one = _attention_tf32(q, k, v, causal=True, window=0, softcap=0.0,
                          passes=1)
    three = _attention_tf32(q, k, v, causal=True, window=0, softcap=0.0)
    assert _rel_l2(one, want) > 1e-5
    assert _rel_l2(three, want) <= 1e-5


# ---------------------------------------------------------------------------
# The 16-bit kernels' number design, emulated on the CPU.  flash.cu's
# Hopper, general and wide kernels take q, k and v in the input's type,
# compute S = q k^T and the online softmax in float32, round p to the
# input's type before P V (l sums the float32 p), accumulate P V in
# float32 and write acc / l in the input's type.  Key tiles of 64; the
# tiles change only the order of the float32 sums.


def _attention_16(q, k, v, *, causal, window, softcap, BK=64, blocks=None):
    """(BH, S, d) attention of 16-bit q, k, v with the kernels' rounding
    of p, in float32 otherwise; returns the input's type.  With
    ``blocks``, S summed as the cluster kernel sums it
    (:func:`_partials`)."""
    dt = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    BH, Sq, d = q.shape
    Skv = k.shape[1]
    scale = d ** -0.5
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, d))
    i = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, BK):
        j = torch.arange(k0, min(k0 + BK, Skv))[None, :]
        kt = k[:, k0:k0 + BK]
        s = (q @ kt.transpose(1, 2) if blocks is None
             else _partials(q, kt, blocks, torch.matmul)) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        ok = torch.ones_like(s[0], dtype=torch.bool)
        if causal:
            ok &= j <= i
        if window > 0:
            ok &= i - j < window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(dt).float() @ v[:, k0:k0 + BK]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(dt)


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap",
                         FLASH_CASES + WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_16_bit_design_matches_plain(B, Sq, Skv, H, d, causal, window,
                                     softcap, dtype):
    """p rounded to float16 (weights off by at most 2**-11 relative) or
    bfloat16 (2**-9) before P V keeps each dtype's contract against the
    plain version on the same 16-bit inputs: float16 within 5e-3 and a
    relative L2 of 2.5e-3, bfloat16 within 2e-2 and 1e-2."""
    tdt = DTYPES[dtype][1]
    q, k, v = (x.to(tdt) for x in _fold_case(B, Sq, Skv, H, d))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _attention_16(q, k, v, **kw).float()
    want = attention_ref(q, k, v, **kw).float()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert _rel_l2(got, want) <= FLASH_REL_L2[dtype]


# ---------------------------------------------------------------------------
# The cluster kernels' fixed sum order, emulated on the CPU.  Past d = 576
# flash_wide_cluster splits d's 64-column chunks between the blocks of a
# cluster (cluster_shares, checked against the kernel's own rule on the
# card); each block's partial S over its chunks (at
# 16 bits the sum of its two warpgroups' halves) is added to the others in
# ascending rank, once, by the block that owns each score, so every block
# holds the same S.


@pytest.mark.parametrize("d", [577, 584, 640, 1024, 1030, 1152, 2048, 2560,
                               2624, 3072, 3584, 4096])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_cluster_shares_cover_the_head(d, elem_bytes):
    """The fewest blocks whose shares hold ``CLUSTER_SHARE`` chunks (at 16
    bits 6 and 7 taken as 8), 2 to 8 of them (a portable cluster),
    balanced, covering d's chunks in rank order."""
    shares = cluster_shares(d, elem_bytes)
    ch, most = -(-d // 64), CLUSTER_SHARE
    fewest = -(-ch // most)
    assert len(shares) == (8 if elem_bytes == 2 and fewest in (6, 7)
                           else fewest)
    assert 2 <= len(shares) <= 8
    assert shares[0][0] == 0 and shares[-1][1] == ch
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [c1 - c0 for c0, c1 in shares]
    assert max(sizes) <= most and max(sizes) - min(sizes) <= 1
    assert flash_ops.CLUSTER_MAXD == 8 * most * 64


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap",
                         CLUSTER_CASES)
def test_3xtf32_design_in_cluster_shares_matches_plain(B, Sq, Skv, H, d,
                                                       causal, window,
                                                       softcap):
    """flash_wide_cluster_f32_kernel: 3xTF32 products in tiles of 96 keys,
    S summed block by block in ascending rank, keeps the float32
    contract."""
    q, k, v = _fold_case(B, Sq, Skv, H, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _attention_tf32(q, k, v, BK=96, blocks=_cluster_columns(d, 4),
                          **kw)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert _rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap",
                         CLUSTER_CASES)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_16_bit_design_in_cluster_shares_matches_plain(B, Sq, Skv, H, d,
                                                       causal, window,
                                                       softcap, dtype):
    """flash_wide_cluster_kernel: each block's partial S (its warpgroups'
    halves added), the blocks' partials in ascending rank, p rounded to
    the input's type before P V: each dtype's contract against the plain
    version."""
    tdt = DTYPES[dtype][1]
    q, k, v = (x.to(tdt) for x in _fold_case(B, Sq, Skv, H, d))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _attention_16(q, k, v, blocks=_cluster_columns(d, 2), **kw).float()
    want = attention_ref(q, k, v, **kw).float()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert _rel_l2(got, want) <= FLASH_REL_L2[dtype]


def test_cluster_sum_order_is_what_the_emulation_adds():
    """The emulation adds as the kernel does, ((P0 + P1) + P2) with each
    block's P its warpgroups' halves added, and the order shows: partials
    of different magnitudes added in reverse rank give other bits, so the
    tests above hold the stated order and not any sum."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.standard_normal((1, 8, 1152))
                             .astype(np.float32)) for _ in range(2))
    q[..., :64] *= 1e4
    blocks = _cluster_columns(1152, 2)
    assert blocks == [[(0, 192), (192, 384)], [(384, 576), (576, 768)],
                      [(768, 960), (960, 1152)]]

    def mm(a, b):
        return q[..., a:b] @ k[..., a:b].transpose(1, 2)
    want = ((mm(0, 192) + mm(192, 384)) + (mm(384, 576) + mm(576, 768))) \
        + (mm(768, 960) + mm(960, 1152))
    assert torch.equal(_partials(q, k, blocks, torch.matmul), want)
    assert not torch.equal(_partials(q, k, blocks[::-1], torch.matmul), want)
