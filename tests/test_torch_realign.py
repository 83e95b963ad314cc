"""K5's realigned wide route on the CPU: the route's choice, the plain
versions of the realigning copy (``kernels/flash/realign.cu``) and the
route's plumbing in ``ops.flash_attention``.

The copy runs only on the card, and ``test_torch_card.py`` is its check
(bit for bit against the plain version at every element offset, both
directions).  Here the plain versions (``ref.pad8_ref``,
``ref.unpad8_ref``, what the wrappers run on CPU tensors) are held to a
NumPy model of the copy's function at every element offset, both
directions (tolerance: none; a copy moves bytes).

The route's plumbing runs ``ops.flash_attention`` with ``on_cpu`` told the
tensors lie on the card and a library of ctypes callbacks with the real
signatures: the copy entry point runs the plain version on the memory it
is given, the attention entry point computes the plain version on the
memory it is given, with the width and the scale it is given.  Held bit
for bit to the plain version on zero-padded inputs with the real d's
scale, cut to d, and at each dtype's limits (``FLASH_TOL``,
``FLASH_REL_L2``) to the plain version on the caller's inputs.  No JAX:
the padded computation against the Pallas kernel is in
``test_torch_flash.py``.
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_parity import FLASH_REL_L2, FLASH_TOL
from repro_torch.kernels import _build
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref

EB = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: head dims of the route's cases: odd, d % 8 != 0, the widest that pads to
#: 576, DeepSeek-V2's absorbed width, the cluster kernel's past it (577
#: pads to 584), its widest (4096) and the general kernel's past that
ROUTE_DIMS = [257, 300, 575, 576, 577, 584, 640, 1030, 4089, 4096, 4097,
              4104]


# ---------------------------------------------------------------------------
# the route's choice


@pytest.mark.parametrize("d", ROUTE_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("offset", [0, 1, 3, 7])
def test_realign_plan_by_shape(d, dtype, offset):
    """Bases ``offset`` elements past a 16-byte boundary, on q alone and on
    all three: the rule of flash_wide and flash_wide_cluster (aligned, d %
    8 == 0, Skv > 0, d <= ``ops.CLUSTER_MAXD``) takes the tensors as they
    are; up to ``CLUSTER_MAXD`` after padding every other shape copies
    each tensor that breaks it, and the output where d % 8 != 0; past it
    nothing is copied (the general wide kernel)."""
    r = offset * EB[DTYPES[dtype]] % 16
    fits = flash_ops.padded(d) <= flash_ops.CLUSTER_MAXD
    for res, bad in (((r, 0, 0), (r != 0, False, False)),
                     ((r, r, r), (r != 0,) * 3)):
        want_copy = tuple(b or d % 8 != 0 for b in bad)
        want = (*want_copy, d % 8 != 0) if fits and any(want_copy) else None
        assert flash_ops.realign_plan(res, d, 9) == want
        assert flash_ops.realign_plan(res, d, 0) is None   # Skv = 0


@pytest.mark.parametrize("d", [1, 64, 200, 255, 256])
def test_realign_plan_leaves_narrow_heads(d):
    """Up to d = 256 the C entry point's own kernels take every shape."""
    assert flash_ops.realign_plan((2, 6, 10), d, 9) is None
    assert flash_ops.realign_plan((0, 0, 0), d, 9) is None


# ---------------------------------------------------------------------------
# the plain copies


def pad8_model(x: np.ndarray) -> np.ndarray:
    """The copy's function in NumPy: rows of d -> rows of d rounded up to
    a multiple of 8, the columns past d zero."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, -x.shape[-1] % 8)])


def unpad8_model(x: np.ndarray, d: int) -> np.ndarray:
    """The way back: the first d columns of each row."""
    return np.ascontiguousarray(x[..., :d])


@pytest.mark.parametrize("d", [3, 257, 300, 575, 576])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pad8_and_unpad8_plain_match_numpy_at_every_offset(d, dtype):
    """The wrappers on CPU tensors (the plain versions) against the NumPy
    model, bit for bit (a copy moves bytes), with the source at every
    element offset past a 16-byte boundary: pad8 from it, unpad8 back,
    and unpad8 of a padded tensor that itself lies at the offset."""
    tdt = DTYPES[dtype]
    bits = {2: np.uint16, 4: np.uint32}[EB[tdt]]
    rng = np.random.default_rng(d)
    x0 = torch.from_numpy(rng.standard_normal((3, 7, d))
                          .astype(np.float32)).to(tdt)
    p0 = flash_ref.pad8_ref(x0)

    def np_bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[EB[tdt]]).numpy() \
            .view(bits)

    for offset in range(16 // EB[tdt]):
        x = _at_offset(x0, offset)
        assert x.data_ptr() % 16 == offset * EB[tdt]
        p = flash_ops.pad8(x)
        assert p.shape == (3, 7, d + -d % 8)
        assert np.array_equal(np_bits(p), pad8_model(np_bits(x)))
        back = flash_ops.unpad8(p, d)
        assert np.array_equal(np_bits(back), unpad8_model(np_bits(p), d))
        assert np.array_equal(np_bits(back), np_bits(x))
        po = _at_offset(p0, offset)
        assert np.array_equal(np_bits(flash_ops.unpad8(po, d)),
                              unpad8_model(np_bits(po), d))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pad8_and_unpad8_plain_round_trip(dtype):
    """The wrappers on CPU tensors (the plain versions): columns past d
    zero, fresh tensors, the round trip the identity, and a launch
    counted nowhere."""
    tdt = DTYPES[dtype]
    x = torch.randn(3, 5, 300).to(tdt)
    before = dict(_build.launches)
    p = flash_ops.pad8(x)
    assert p.shape == (3, 5, 304) and p.dtype == tdt
    assert torch.equal(p[..., :300], x) and not p[..., 300:].any()
    back = flash_ops.unpad8(p, 300)
    assert torch.equal(back, x) and back.is_contiguous()
    assert dict(_build.launches) == before
    with pytest.raises(ValueError, match="do not pad"):
        flash_ops.unpad8(p, 296)


# ---------------------------------------------------------------------------
# the route's plumbing, with the copy replayed on the tensors' memory


def _tensor(ptr: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The memory at ``ptr`` as a tensor."""
    n = int(np.prod(shape)) * dtype.itemsize
    return torch.frombuffer((ctypes.c_ubyte * n).from_address(ptr),
                            dtype=dtype).view(shape)


class FakeLibrary:
    """K5's C entry points as ctypes callbacks: the copy runs its plain
    version on the memory it is given, bit for bit; attention computes the
    plain version on the memory it is given and returns the code of the
    kernel flash.cu's rule would take (tma_shape, then d <= WIDE_MAXD or
    d <= CLUSTER_MAXD)."""

    def __init__(self):
        self.calls = []
        for fn in ("repro_flash_attn_f32", "repro_flash_attn_bf16",
                   "repro_flash_attn_f16"):
            setattr(self, fn, self._entry(fn, self._attention(fn)))
        self.repro_flash_realign = self._entry("repro_flash_realign",
                                               self._realign)

    def _entry(self, name, body):
        def fn(*a):
            self.calls.append((name, a))
            return body(*a)
        return ctypes.CFUNCTYPE(ctypes.c_int, *_build._SIGNATURES[name])(fn)

    @staticmethod
    def _realign(src, dst, rows, d, eb, unpad, stream):
        dp, bits = d + -d % 8, {2: torch.int16, 4: torch.int32}[eb]
        if not unpad:
            assert dst % 16 == 0 and src % eb == 0
            _tensor(dst, (rows, dp), bits).copy_(
                flash_ref.pad8_ref(_tensor(src, (rows, d), bits)))
        else:
            assert src % 16 == 0 and dst % eb == 0
            _tensor(dst, (rows, d), bits).copy_(
                flash_ref.unpad8_ref(_tensor(src, (rows, dp), bits), d))
        return 0

    @staticmethod
    def _attention(fn):
        dtype = {"repro_flash_attn_f32": torch.float32,
                 "repro_flash_attn_bf16": torch.bfloat16,
                 "repro_flash_attn_f16": torch.float16}[fn]

        def body(q, k, v, o, BH, Sq, Skv, d, causal, window, softcap, scale,
                 stream):
            qt = _tensor(q, (BH, Sq, d), dtype)
            kt, vt = (_tensor(x, (BH, Skv, d), dtype) for x in (k, v))
            _tensor(o, (BH, Sq, d), dtype).copy_(flash_ref.attention_ref(
                qt, kt, vt, causal=bool(causal), window=window,
                softcap=softcap, scale=scale))
            tma = d % 8 == 0 and Skv > 0 and (q | k | v | o) % 16 == 0
            key = ("flash_wide" if tma and d <= flash_ops.WIDE_MAXD else
                   "flash_wide_cluster" if tma and d <= flash_ops.CLUSTER_MAXD
                   else "flash_wide_general")
            return -flash_ops._KEYS[dtype].index(key)
        return body


def _at_offset(x: torch.Tensor, elems: int) -> torch.Tensor:
    """A copy of ``x`` whose base lies ``elems`` elements past the start of
    a buffer with 16 elements to spare after it."""
    buf = torch.zeros(x.numel() + elems + 16, dtype=x.dtype)
    return buf[elems:elems + x.numel()].view(x.shape).copy_(x)


@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda name, t: False)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    return lib


#: (d, offset, k is v): the route's shapes on the realigned route and on
#: either side of it, on flash_wide and on flash_wide_cluster
ROUTE_CASES = [(300, 0, False), (300, 3, True), (575, 1, False),
               (576, 1, False), (576, 7, True), (577, 1, False),
               (584, 0, False), (576, 0, False), (640, 3, True),
               (1030, 1, False), (1024, 0, False), (4096, 1, False),
               (4097, 1, False), (4104, 0, False)]


@pytest.mark.parametrize("d,offset,same_kv", ROUTE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_route_on_realigned_scratch(fake_card, d, offset,
                                                    same_kv, dtype):
    """``flash_attention`` at bases ``offset`` elements past a 16-byte
    boundary (k the same tensor as v where ``same_kv``): the copies it
    launches, the width, pointers and scale it passes, and its output."""
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(d + offset)
    BH, Sq, Skv = 2, 11, 13
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, s, d))
                                .astype(np.float32)).to(tdt)
               for s in (Sq, Skv, Skv))
    q, k, v = (_at_offset(x, offset) for x in (q, k, v))
    if same_kv:
        k = v
    before = dict(_build.launches)
    got = flash_ops.flash_attention(q, k, v, causal=True, window=9,
                                    softcap=30.0)
    added = {n: c - before.get(n, 0) for n, c in _build.launches.items()
             if c != before.get(n, 0)}
    plan = flash_ops.realign_plan(tuple(x.data_ptr() % 16 for x in (q, k, v)),
                                  d, Skv)
    dp = d + -d % 8
    if plan is None:
        assert added == {(flash_ops.wide_key(d) if offset == 0
                          else "flash_wide_general"): 1}
    else:
        assert added == {"flash_realign": sum(plan),
                         flash_ops.wide_key(d): 1}
    (name, args), = [c for c in fake_card.calls if c[0] != "repro_flash_realign"]
    assert args[4:11] == (BH, Sq, Skv, dp if plan else d, 1, 9, 30.0)
    assert args[11] == pytest.approx(d ** -0.5, rel=1e-7)   # the real d's
    if plan is not None:
        assert all(p % 16 == 0 for p in args[:4])
    assert got.shape == (BH, Sq, d) and got.dtype == tdt
    kw = dict(causal=True, window=9, softcap=30.0, scale=d ** -0.5)
    if plan is not None:   # the plain version on the padded inputs, cut
        padded = flash_ref.attention_ref(*(flash_ref.pad8_ref(x)
                                           for x in (q, k, v)), **kw)
        assert torch.equal(got, flash_ref.unpad8_ref(padded, d))
    want = flash_ref.attention_ref(q, k, v, **kw).float()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert float((got.float() - want).norm() / want.norm()) \
        <= FLASH_REL_L2[dtype]
