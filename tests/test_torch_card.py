"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests carry the ``cuda``
marker and skip where there is no card.  They import no JAX (the machine
with the card has none); run them there with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Tolerance: none for K1-K4.  int32 inputs, and float32 inputs whose sums
stay below 2**24, give bit-identical results; the probe and rectload
kernels are bit-identical for any input.  The SAT kernels (K1, K4) sum
float32 in another order than ``torch.cumsum``, so the float32 cases here
keep integer loads with frame totals below 2**24, except
``test_sat_float32_above_2_24``, held to 1e-6 of the frame total against
the exact int64 prefix (``chip_smoke.py``'s limit); float64 (K1, K4) on
integer loads up to 2**30 is exact and held to the exact prefix.  The
sharded planner on a mesh that names the card more than once is held to
the single-device plan bit for bit.  The flash attention
kernel (K5) sums in tiles with an online softmax, the plain version
densely: ``tests/test_flash.py``'s tolerances, 2e-5 for float32 and 2e-2
for bfloat16, and 5e-3 for float16 (about two float16 ulps at the
outputs' magnitude), compared in float32, beside a relative L2 error of
1e-5, 1e-2 and 2.5e-3, with the plain version's float32 products in full
float32 (no TF32); against the model layer's chunked attention 3e-5 in
float32, that test's own.  The models and a train step
run no kernel; they are held to the port's CPU path (1e-4 x max, and for
a train step the limits its test states).  The sharded steps
(``launch.steps.build_*``) on the card's meshes are held to the unmeshed
path on the card bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (FLASH_CASES, FLASH_REL_L2, FLASH_TOL,
                           alternating_case, cluster_shares,
                           big_total_case, int_loads, long_run_case,
                           need_card, plateau_case, probe_case, qkv,
                           rectload_case, solver_case)
from repro_torch import configs
from repro_torch.core import device, prefix, registry, sgorp
from repro_torch.kernels import _build
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.probe import ops as probe_ops
from repro_torch.kernels.probe import ref as probe_ref
from repro_torch.kernels.rectload import ops as rl_ops
from repro_torch.kernels.rectload import ref as rl_ref
from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.kernels.sat import ref as sat_ref
from repro_torch.models import encdec, layers, lm
from repro_torch.rebalance import planner, stream

pytestmark = pytest.mark.cuda
DTYPES = {"int32": torch.int32, "float32": torch.float32}
FLASH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


@pytest.mark.parametrize("shape", [(1, 1), (7, 9), (33, 65), (3, 17, 130),
                                   (2, 40, 29), (4, 0, 5), (3, 512, 512)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sat_kernel_matches_plain(shape, dtype):
    dev = need_card()
    a = torch.from_numpy(int_loads(shape, np.int64)).to(DTYPES[dtype]).to(dev)
    n = _build.launches["sat"]
    got = sat_ops.gamma(a)
    assert _build.launches["sat"] == n + 1
    assert torch.equal(got, sat_ref.gamma_ref(a))


@pytest.mark.parametrize("S,n,K,cap", [
    (1, 0, 3, 2), (5, 17, 7, 4), (64, 512, 8, 32), (3, 13000, 5, 20),
    (6, 33, 300, 3), (2, 9, 5, 0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_kernel_matches_plain(S, n, K, cap, dtype):
    dev = need_card()
    p, Ls = (torch.from_numpy(x).to(DTYPES[dtype]).to(dev)
             for x in probe_case(S, n, K))
    c = _build.launches["probe"]
    got = probe_ops.probe_counts(p, Ls, cap)
    assert _build.launches["probe"] == c + 1
    assert torch.equal(got, probe_ref.probe_counts_ref(p, Ls, cap))


@pytest.mark.parametrize("B,n1,n2,P,Q", [
    (1, 16, 16, 2, 2), (3, 33, 40, 4, 3), (64, 512, 512, 32, 993)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batched", [True, False])
def test_rectload_kernel_matches_plain(B, n1, n2, P, Q, dtype, batched):
    dev = need_card()
    g, rc, cc, _ = (torch.from_numpy(x).to(dev)
                    for x in rectload_case(B, n1, n2, P, Q))
    g = g.to(DTYPES[dtype])
    if not batched:
        g, rc, cc = g[0], rc[0], cc[0]
    c = _build.launches["rectload"]
    got = rl_ops.jagged_loads(g, rc, cc)
    assert _build.launches["rectload"] == c + 1
    assert torch.equal(got, rl_ref.jagged_loads_ref(g, rc, cc).float())


def _probe_case_on_card(p, Ls, cap, dtype, key="probe"):
    """K2 on the card launches once under ``key`` (the route its row
    length chooses) and equals the plain version bit for bit."""
    dev = need_card()
    p, Ls = (torch.from_numpy(x).to(DTYPES[dtype]).to(dev) for x in (p, Ls))
    c = _build.launches[key]
    got = probe_ops.probe_counts(p, Ls, cap)
    assert _build.launches[key] == c + 1
    assert torch.equal(got, probe_ref.probe_counts_ref(p, Ls, cap))
    return got


# the window scan's edges: intervals past one window (32 entries) and past
# 32 windows (1,024); K above a block's 8 walks (one warp walks K = 40 and
# 200 eight at a time), K not a multiple of them (K = 1, 3); grids of up
# to 9,001 one-row blocks; n = 0, cap = 0
@pytest.mark.parametrize("case,S,n,K,cap", [
    ("long", 6, 100, 5, 8), ("long", 8, 3000, 6, 12),
    ("long", 4, 20000, 4, 40), ("long", 300, 2000, 8, 32),
    ("probe", 2047, 512, 8, 32), ("probe", 4000, 200, 40, 16),
    ("probe", 9, 60, 200, 5), ("probe", 9001, 100, 8, 16),
    ("probe", 50, 70, 1, 9), ("probe", 50, 70, 3, 9),
    ("probe", 4, 0, 3, 2), ("probe", 5, 17, 7, 0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_kernel_window_edges(case, S, n, K, cap, dtype):
    make = long_run_case if case == "long" else probe_case
    _probe_case_on_card(*make(S, n, K), cap, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_kernel_row_at_the_shared_memory_limit(dtype):
    """A row of 58,112 entries fills a block's 232,448 bytes of shared
    memory and is staged (``probe``); one more entry takes the general
    route (``probe_general``), bit-identical to the plain version too."""
    n = probe_ops._SMEM_MAX // 4 - 1
    _probe_case_on_card(*long_run_case(2, n, 4), 24, dtype)
    _probe_case_on_card(*long_run_case(2, n + 1, 4), 24, dtype,
                        key="probe_general")


# K2's general route: rows past shared memory (58,113 entries, a 4 MB row
# of 1,048,577), with the window walk's edges (intervals past 32 and
# 1,024 entries) and cap = 0
@pytest.mark.parametrize("case,S,n,K,cap", [
    ("long", 2, 58112, 6, 24), ("probe", 3, 58112, 9, 40),
    ("long", 1, 1048576, 15, 1024), ("probe", 2, 1048576, 15, 64),
    ("probe", 2, 58112, 5, 0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_general_route_matches_plain(case, S, n, K, cap, dtype):
    make = long_run_case if case == "long" else probe_case
    _probe_case_on_card(*make(S, n, K), cap, dtype, key="probe_general")


# the general kernel on the staged route's cases, driven on purpose
# (``ops._launch``): n = 0, cap = 0, K past a block's walks, many rows
@pytest.mark.parametrize("case,S,n,K,cap", [
    ("probe", 4, 0, 3, 2), ("probe", 5, 17, 7, 0), ("probe", 9, 60, 200, 5),
    ("probe", 2047, 512, 8, 32), ("long", 8, 3000, 6, 12),
    ("long", 4, 20000, 4, 40)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_general_kernel_on_short_rows(case, S, n, K, cap, dtype):
    dev = need_card()
    make = long_run_case if case == "long" else probe_case
    p, Ls = (torch.from_numpy(x).to(DTYPES[dtype]).to(dev)
             for x in make(S, n, K))
    c = _build.launches["probe_general"]
    got = probe_ops._launch(p, Ls, cap, "probe_general")
    assert _build.launches["probe_general"] == c + 1
    assert torch.equal(got, probe_ref.probe_counts_ref(p, Ls, cap))


# the general route's design at its edges: windows predicted from the last
# interval that miss on both sides (intervals alternating between a few
# entries and tens of thousands), runs of equal prefixes longer than a
# window (the interval ends at a run's last entry), one row with 1 to 200
# walks (a warp each), 12,000 walks on rows of 58,114 entries
GENERAL_EDGES = {"alternating": alternating_case, "plateau": plateau_case,
                 "solver": solver_case, "probe": probe_case}


@pytest.mark.parametrize("case,S,n,K,cap", [
    ("alternating", 2, 300000, 8, 64), ("alternating", 1, 1048576, 6, 200),
    ("plateau", 3, 200000, 6, 200), ("plateau", 1, 58112, 4, 450),
    ("solver", 1, 1048576, 1, 1024), ("solver", 1, 1048576, 15, 1024),
    ("solver", 1, 1048576, 33, 1024), ("solver", 1, 1048576, 200, 1024),
    ("probe", 300, 58113, 40, 32)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_general_route_design_edges(case, S, n, K, cap, dtype):
    _probe_case_on_card(*GENERAL_EDGES[case](S, n, K), cap, dtype,
                        key="probe_general")


def test_probe_general_route_int32_totals_below_2_30():
    """int32 rows whose totals are 2**30 - 1: targets pass 2**30 and stay
    below 2**31, bit-identical to the plain version's int32 adds."""
    p, Ls = big_total_case(3, 100000, 12)
    assert p[:, -1].max() == 2 ** 30 - 1
    _probe_case_on_card(p, Ls, 64, "int32", key="probe_general")


@pytest.mark.parametrize("S,n,K,cap", [(1, 0, 1, 5), (3, 0, 15, 0),
                                       (2, 58112, 15, 0),
                                       (1, 1048576, 200, 0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_general_kernel_at_n_0_and_cap_0(S, n, K, cap, dtype):
    """An empty row counts 1; cap = 0 gives cap + 1 = 1 on a row that has
    entries: both through the general kernel (``ops._launch``)."""
    dev = need_card()
    p, Ls = (torch.from_numpy(x).to(DTYPES[dtype]).to(dev)
             for x in solver_case(S, n, K))
    c = _build.launches["probe_general"]
    got = probe_ops._launch(p, Ls, cap, "probe_general")
    assert _build.launches["probe_general"] == c + 1
    assert torch.equal(got, probe_ref.probe_counts_ref(p, Ls, cap))
    assert bool((got == 1).all())


def _rectload_on_card(g, rc, cc):
    c = _build.launches["rectload"]
    got = rl_ops.jagged_loads(g, rc, cc)
    assert _build.launches["rectload"] == c + 1
    return got


# column runs: Q+1 not a multiple of a warp's 32 cuts, many frames of 32
# stripes, P = 1, empty stripes (more stripes than rows)
@pytest.mark.parametrize("B,n1,n2,P,Q", [
    (1, 20, 600, 3, 31), (1, 20, 600, 2, 127), (2, 20, 2000, 2, 1022),
    (1, 40, 300, 1, 200), (2, 5, 40, 9, 4), (64, 40, 1100, 2, 1023),
    (16, 40, 1000, 32, 993), (32, 40, 1000, 32, 993),
    (64, 64, 200, 32, 129)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rectload_kernel_column_runs(B, n1, n2, P, Q, dtype):
    dev = need_card()
    g, rc, cc, _ = (torch.from_numpy(x).to(dev)
                    for x in rectload_case(B, n1, n2, P, Q))
    g = g.to(DTYPES[dtype])
    got = _rectload_on_card(g, rc, cc)
    assert torch.equal(got, rl_ref.jagged_loads_ref(g, rc, cc).float())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rectload_kernel_stream_of_padded_plans(dtype):
    """A stream's 64 plans in one launch, as pricing would hand them over:
    P = 32, m = 1024, 993 intervals a stripe with the dead ones pinned at
    n2 (``Plan._live_col_cuts``)."""
    dev = need_card()
    fr = stream.STREAMS["refinement-bursts"](64, 512, 512, seed=0)
    rc, counts, cc, _ = planner.plan_stream(fr, P=32, m=1024, device=dev)
    live = torch.arange(cc.shape[2], device=dev) <= counts[..., None]
    cc = torch.where(live, cc, 512).int()
    assert cc.shape == (64, 32, 994)
    g = torch.stack([torch.from_numpy(prefix.prefix_sum_2d(f)) for f in fr])
    g = g.to(DTYPES[dtype]).to(dev)
    got = _rectload_on_card(g, rc, cc)
    assert torch.equal(got, rl_ref.jagged_loads_ref(g, rc, cc).float())


@pytest.mark.parametrize("bad", [-1, 601])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rectload_kernel_cut_outside_gamma_gives_nan(bad, dtype):
    """A column cut outside the Gamma turns exactly its two neighbouring
    rectangles NaN; a row cut outside it, its whole stripe."""
    dev = need_card()
    g, rc, cc, _ = (torch.from_numpy(x).to(dev)
                    for x in rectload_case(2, 30, 600, 3, 300))
    g = g.to(DTYPES[dtype])
    want = rl_ref.jagged_loads_ref(g, rc, cc).float()
    cc2 = cc.clone()
    cc2[1, 2, 124] = bad      # a column two warps' runs share
    got = _rectload_on_card(g, rc, cc2)
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[1, 2, 123:125] = True
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])
    rc2 = rc.clone()
    rc2[0, 1] = bad if bad < 0 else 31
    got = _rectload_on_card(g, rc2, cc)
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[0, :2] = True
    assert torch.equal(got.isnan(), nan)


def test_rectload_kernel_int32_wraps_like_plain():
    """An int32 Gamma past 2**31: stripe values and their differences wrap
    as the plain version's int32 arithmetic does."""
    dev = need_card()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 2 ** 20, (2, 64, 300))).to(dev)
    exact = torch.nn.functional.pad(a.cumsum(1).cumsum(2), [1, 0, 1, 0])
    assert int(exact.max()) > 2 ** 31
    g = ((exact + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    _, rc, cc, _ = (torch.from_numpy(x).to(dev)
                    for x in rectload_case(2, 64, 300, 3, 200, seed=3))
    got = _rectload_on_card(g, rc, cc)
    assert torch.equal(got, rl_ref.jagged_loads_ref(g, rc, cc).float())


@pytest.mark.parametrize("name", sorted(stream.STREAMS))
@pytest.mark.parametrize("exact", [False, True])
def test_planner_on_card_matches_cpu(name, exact):
    """The whole path through the kernels equals the CPU path through the
    plain versions (frame totals below 2**24)."""
    dev = need_card()
    fr = stream.STREAMS[name](3, 48, 64, seed=5)
    before = dict(_build.launches)
    got = planner.plan_stream(fr, P=4, m=16, exact=exact, device=dev)
    want = planner.plan_stream(fr, P=4, m=16, exact=exact, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)
    assert _build.launches["sat"] == before.get("sat", 0) + 1
    if exact:
        assert _build.launches["probe"] > before.get("probe", 0)


def _small_int_loads(shape, high, seed=0):
    return np.random.default_rng(seed).integers(0, high, shape)


@pytest.mark.parametrize("shape,high", [
    ((1, 1, 1), 100), ((5, 7, 9), 100), ((3, 17, 33, 130), 100),
    ((2, 40, 29, 3), 100), ((2, 0, 4, 5), 100), ((3, 6, 0, 2), 100),
    ((1, 200, 3, 70), 100),
    ((16, 128, 128, 128), 8)])   # the 3D path's shape, totals < 2**24
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sat3_kernel_matches_plain(shape, high, dtype):
    dev = need_card()
    a = torch.from_numpy(_small_int_loads(shape, high)).to(
        DTYPES[dtype]).to(dev)
    n = _build.launches["sat3"]
    got = sat_ops.gamma3(a)
    assert _build.launches["sat3"] == n + 1
    torch.cuda.synchronize()
    assert torch.equal(got, sat_ref.gamma3_ref(a))
    assert torch.equal(sat_ops.sat3(a), got[..., 1:, 1:, 1:])


def _sat_case(fn, key, shape, high, dtype, seed=0):
    """``fn`` on the card counts one launch under ``key`` (and none under
    the other SAT keys) and equals the plain version bit for bit."""
    dev = need_card()
    a = torch.from_numpy(_small_int_loads(shape, high, seed)).to(
        DTYPES[dtype]).to(dev)
    before = {k: _build.launches[k] for k in SAT_KEYS}
    got = fn(a)
    added = {k: _build.launches[k] - n for k, n in before.items()}
    assert added == {k: int(k == key) for k in SAT_KEYS}
    torch.cuda.synchronize()
    want = (sat_ref.gamma_ref if fn is sat_ops.gamma
            else sat_ref.gamma3_ref)(a)
    assert torch.equal(got, want)


SAT_KEYS = ("sat", "sat3", "sat3_general")


# band and tile edges of K1: rows not a multiple of the band height (64),
# n1 = 1, n2 = 1, n2 not a multiple of 4, rows past one 128-column chunk,
# more than 64 bands (the reduce's group), B = 1 and B = 64 at 512 x 512
@pytest.mark.parametrize("shape", [
    (3, 130, 200), (5, 1, 1), (2, 1, 700), (2, 700, 1), (2, 65, 131),
    (2, 300, 1030), (1, 4480, 3), (1, 1000, 37), (1, 512, 512),
    (64, 512, 512)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sat_kernel_band_edges(shape, dtype):
    _sat_case(sat_ops.gamma, "sat", shape, 100, dtype)


# band and plane edges of K4's fast route: n1 not a multiple of the band
# (S = 17, and S = 4 with a 1-slab last band), 1 x 1 planes, the largest
# plane of each class (64 x 256, 512 x 32), B = 1 at the path's 128^3
@pytest.mark.parametrize("shape", [
    (16, 130, 17, 19), (1, 301, 5, 7), (3, 33, 1, 1), (2, 3, 64, 256),
    (1, 5, 512, 32), (2, 9, 100, 70), (1, 128, 128, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sat3_kernel_band_edges(shape, dtype):
    high = 8 if shape == (1, 128, 128, 128) else 100
    _sat_case(sat_ops.gamma3, "sat3", shape, high, dtype)


# planes that do not fit K4's fast route: n3 > 256, n2 > 512, n2 > 64
# with n3 > 128; empty slabs and empty planes
@pytest.mark.parametrize("shape", [
    (2, 5, 20, 300), (1, 3, 600, 17), (2, 4, 70, 130), (1, 0, 600, 17),
    (2, 3, 0, 300)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sat3_general_route_matches_plain(shape, dtype):
    assert sat_ops.sat3_plan(*shape, 132)[0] == "sat3_general"
    _sat_case(sat_ops.gamma3, "sat3_general", shape, 100, dtype)


def _exact_gamma(a64: torch.Tensor, axes: int) -> torch.Tensor:
    """Exclusive prefix in int64 over the trailing ``axes`` axes."""
    s = a64
    for d in range(-axes, 0):
        s = torch.cumsum(s, dim=d)
    pad = [1, 0] * axes
    return torch.nn.functional.pad(s, pad)


# float32 above 2**24 at the main paths' shapes (frame totals about 5e8):
# within 1e-6 of the frame total of the exact int64 prefix
@pytest.mark.parametrize("fn,key,shape,high", [
    ("gamma", "sat", (64, 512, 512), 4000),
    ("gamma3", "sat3", (16, 128, 128, 128), 400),
    ("gamma3", "sat3_general", (2, 64, 40, 300), 4000)])
def test_sat_float32_above_2_24(fn, key, shape, high):
    dev = need_card()
    a64 = torch.from_numpy(_small_int_loads(shape, high, seed=3)).to(dev)
    axes = len(shape) - 1
    exact = _exact_gamma(a64, axes)
    total = exact.reshape(shape[0], -1)[:, -1].double()
    assert float(total.min()) > 2 ** 24
    n = _build.launches[key]
    got = getattr(sat_ops, fn)(a64.float())
    assert _build.launches[key] == n + 1
    err = ((got.double() - exact.double()).abs().reshape(shape[0], -1)
           / total[:, None]).max()
    assert float(err) <= 1e-6


# int32 whose partial sums pass 2**31: bit-identical to
# torch.cumsum(dtype=int32) and to the exact prefix wrapped mod 2**32
@pytest.mark.parametrize("fn,key,shape,high", [
    ("gamma", "sat", (4, 512, 512), 2 ** 20),
    ("gamma3", "sat3", (2, 128, 128, 128), 2 ** 16),
    ("gamma3", "sat3_general", (2, 16, 40, 300), 2 ** 20)])
def test_sat_int32_wraps_like_cumsum(fn, key, shape, high):
    dev = need_card()
    a64 = torch.from_numpy(_small_int_loads(shape, high, seed=4)).to(dev)
    exact = _exact_gamma(a64, len(shape) - 1)
    assert int(exact.max()) > 2 ** 31
    wrapped = ((exact + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    a = a64.to(torch.int32)
    n = _build.launches[key]
    got = getattr(sat_ops, fn)(a)
    assert _build.launches[key] == n + 1
    assert torch.equal(got, wrapped)
    want = (sat_ref.gamma_ref if fn == "gamma" else sat_ref.gamma3_ref)(a)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(stream.STREAMS_3D))
@pytest.mark.parametrize("gamma_dtype", list(DTYPES))
def test_planner3d_on_card_matches_cpu(name, gamma_dtype):
    """The 3D path through K4 equals the CPU path through the plain
    version, bit for bit (frame totals below 2**24)."""
    dev = need_card()
    fr = stream.STREAMS_3D[name](3, 14, 16, 18, seed=5)
    gd = DTYPES[gamma_dtype]
    before = _build.launches["sat3"]
    got = planner.plan_stream(fr, P=0, m=12, gamma_dtype=gd, device=dev)
    want = planner.plan_stream(fr, P=0, m=12, gamma_dtype=gd, device="cpu")
    assert len(got) == 6
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)
    assert _build.launches["sat3"] == before + 1


@pytest.mark.parametrize("speeds", [None, [1, 2, 1, 1, 3, 1, 1, 2]])
def test_sgorp_host_entries_on_card_match_cpu(speeds):
    dev = need_card()
    vol = prefix.amr_like_instance_3d(12, 10, 14, seed=2)
    got = sgorp.sgorp_3d(vol, 8, speeds=speeds, device=dev)
    want = sgorp.sgorp_3d(vol, 8, speeds=speeds, device="cpu")
    assert got.boxes == want.boxes and got.is_valid()
    g2 = prefix.prefix_sum_2d(vol.sum(axis=0))
    assert sgorp.sgorp_2d(g2, 8, speeds=speeds, device=dev).rects == \
        sgorp.sgorp_2d(g2, 8, speeds=speeds, device="cpu").rects


def _registry_gamma(kind):
    A = prefix.pic_like_instance(40, 36, iteration=300, seed=3)
    g = prefix.prefix_sum_2d(A)
    return g if kind == "int32" else (g / 7.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["int32", "float32", "speeds"])
@pytest.mark.parametrize("orient", ["hor", "ver", "best"])
def test_registry_jag_pq_opt_device_on_card_matches_cpu(kind, orient):
    """``jag-pq-opt-device`` on the card equals the CPU path rectangle for
    rectangle (int32, float32 and ``speeds=`` with two dead parts); the
    homogeneous column probes went through K2 (the speeds branch walks its
    columns with ``torch.searchsorted``)."""
    dev = need_card()
    g = _registry_gamma("int32" if kind == "speeds" else kind)
    kw = {"P": 4, "Q": 4, "orient": orient}
    if kind == "speeds":
        sp = np.random.default_rng(4).uniform(0.25, 4.0, 16)
        sp[[2, 9]] = 0.0
        kw["speeds"] = sp
    before = _build.launches["probe"]
    got = registry.partition("jag-pq-opt-device", g, 16, device=dev, **kw)
    want = registry.partition("jag-pq-opt-device", g, 16, device="cpu", **kw)
    assert got.rects == want.rects
    assert got.max_load(g) == want.max_load(g)
    assert (_build.launches["probe"] > before) == (kind != "speeds")


@pytest.mark.parametrize("kind", ["int32", "float32"])
@pytest.mark.parametrize("orient", ["hor", "ver", "best"])
def test_registry_jag_m_opt_device_on_card_matches_cpu(kind, orient):
    dev = need_card()
    g = _registry_gamma(kind)[:25, :21]
    got = registry.partition("jag-m-opt-device", g, 6, orient=orient,
                             device=dev)
    want = registry.partition("jag-m-opt-device", g, 6, orient=orient,
                              device="cpu")
    assert got.rects == want.rects


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [4096, 70000])
def test_nicol_optimal_device_on_card_matches_cpu(dtype, n):
    """The exact 1D solver on the card, on a row that K2 stages and on one
    that takes its general route, equals the CPU path."""
    dev = need_card()
    p, _ = probe_case(2, n, 1, seed=6)
    p = torch.from_numpy(p[1:]).to(DTYPES[dtype])
    key = probe_ops.route(n + 1)
    before = _build.launches[key]
    got = device.nicol_optimal_device_impl(p.to(dev), 37)
    want = device.nicol_optimal_device_impl(p, 37)
    assert _build.launches[key] > before
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


#: launch keys of K5's kernels by dtype (which one takes a call is the C
#: entry point's choice)
FLASH_KEYS = {name: flash_ops._KEYS[dt] for name, dt in FLASH_DTYPES.items()}
#: the general kernel's key by 16-bit dtype
GENERAL = {"bfloat16": "flash_general", "float16": "flash_f16_general"}


def _held(got: torch.Tensor, want: torch.Tensor, dtype: str) -> None:
    """K5's output against the plain version's at ``dtype``'s limits:
    elementwise (rtol = atol) and relative L2, compared in float32."""
    got, want = got.float(), want.float()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    norm = float(want.norm())
    if norm > 0:
        assert float((got - want).norm()) / norm <= FLASH_REL_L2[dtype]


def _clusters_seen(d: int, dtype: str, cluster: bool) -> None:
    """The cluster size of the launch just made, as its kernel read it
    from ``%cluster_nctarank`` (``ops.cluster_blocks_seen``, which clears
    the record): ``cluster_shares``'s count at d padded to a multiple of 8
    where ``flash_wide_cluster`` ran, else 0 (no cluster launch)."""
    eb = FLASH_DTYPES[dtype].itemsize
    want = len(cluster_shares(flash_ops.padded(d), eb)) if cluster else 0
    assert flash_ops.cluster_blocks_seen() == want


def _flash_case(B, Sq, Skv, H, d, causal, window, softcap, dtype, seed=0,
                q_scale=1.0, key=None):
    """K5 through ``attention`` on the card against the plain version on
    the same (folded) inputs; one launch is counted, under ``key`` where
    the case names the route it must take."""
    dev = need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    q, k, v = qkv(B, Sq, Skv, H, d, seed)
    q, k, v = (torch.from_numpy(x).to(dev, FLASH_DTYPES[dtype])
               for x in (q * np.float32(q_scale), k, v))
    before = {n: _build.launches[n] for n in FLASH_KEYS[dtype]}
    copies = _build.launches["flash_realign"]
    flash_ops.cluster_blocks_seen()
    got = flash_ops.attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    added = {n: _build.launches[n] - c for n, c in before.items()}
    assert sum(added.values()) == 1
    if key is not None:
        assert added[key] == 1
    _clusters_seen(d, dtype, added.get("flash_wide_cluster", 0) == 1)
    # attention folds into fresh, aligned tensors
    assert _build.launches["flash_realign"] - copies == \
        _realigns(d, 0, dtype, Skv)
    torch.cuda.synchronize()

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, -1, d).contiguous()

    want = flash_ref.attention_ref(fold(q), fold(k), fold(v), causal=causal,
                                   window=window, softcap=softcap)
    want = want.reshape(B, H, Sq, d).transpose(1, 2)
    assert got.dtype == q.dtype and got.shape == (B, Sq, H, d)
    _held(got, want, dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,d,causal,window,softcap", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_kernel_matches_plain(B, Sq, Skv, H, d, causal, window,
                                    softcap, dtype):
    _flash_case(B, Sq, Skv, H, d, causal, window, softcap, dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 200, 256])  # 200: not a
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))       # compiled width
@pytest.mark.parametrize("mode", ["causal-window-softcap", "cross"])
def test_flash_kernel_head_dims(d, dtype, mode):
    if mode == "cross":   # Sq < Skv, no mask, neither a multiple of a tile
        _flash_case(1, 70, 197, 2, d, False, 0, 0.0, dtype, seed=d)
    else:
        _flash_case(1, 130, 130, 2, d, True, 48, 50.0, dtype, seed=d)


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_kernel_many_heads(dtype):
    """B * H = 66,000 > 65,535: the flattened grid takes it."""
    _flash_case(2, 16, 16, 33000, 32, True, 0, 0.0, dtype)


# the Hopper kernel's tiles: 128 query rows, 128 keys at d <= 128 and 64
# keys at d = 256
EDGE_LENGTHS = [(1, 1, True), (127, 127, True), (129, 129, True),
                (257, 257, True), (1000, 1000, True), (1, 1000, False),
                (127, 257, False), (1000, 129, True), (257, 1, False)]


@pytest.mark.parametrize("Sq,Skv,causal", EDGE_LENGTHS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_hopper_tile_edges(Sq, Skv, causal, d):
    """Ragged query and key lengths on both sides of a tile edge."""
    _flash_case(1, Sq, Skv, 2, d, causal, 0, 0.0, "bfloat16", seed=Sq + Skv,
                key="flash")


@pytest.mark.parametrize("window", [64, 100, 128])   # on / inside a tile
@pytest.mark.parametrize("d", [128, 256])
def test_flash_hopper_window_edges(window, d):
    _flash_case(1, 512, 512, 2, d, True, window, 0.0, "bfloat16", seed=window,
                key="flash")


@pytest.mark.parametrize("window", [0, 256])
def test_flash_hopper_gemma2_softcap(window):
    """d=256 global and local layers at S=1024 with Gemma-2's softcap 50,
    q drawn 8x larger so the softcap changes the logits."""
    _flash_case(1, 1024, 1024, 2, 256, True, window, 50.0, "bfloat16",
                q_scale=8.0, key="flash")


# 72: TMA can describe it, not a compiled width; 70: d % 8 != 0
@pytest.mark.parametrize("d,key", [(72, "flash"), (70, "flash_general")])
def test_flash_widths_route_by_shape(d, key):
    _flash_case(1, 200, 300, 2, d, True, 48, 50.0, "bfloat16", seed=d,
                key=key)
    _flash_case(1, 70, 197, 2, d, False, 0, 0.0, "bfloat16", seed=d, key=key)


def _at_offset(x: np.ndarray, dev, dtype, elems: int) -> torch.Tensor:
    """A contiguous copy of ``x`` on the card whose base lies ``elems``
    elements past the start of its buffer."""
    buf = torch.zeros(x.size + elems, dtype=dtype, device=dev)
    return buf[elems:].view(x.shape).copy_(torch.from_numpy(
        np.ascontiguousarray(x)))


def _flash_folded(BH, Sq, Skv, d, dtype, key, *, offset=1, causal=True,
                  window=0, softcap=0.0, seed=0, q_scale=1.0, f64=False):
    """K5 through ``flash_attention`` on (BH, S, d) inputs whose bases lie
    ``offset`` elements past a 16-byte boundary, against the plain version
    (with ``f64``, its function computed in float64); one launch, counted
    under ``key``."""
    dev = need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = FLASH_DTYPES[dtype]
    q, k, v = (x[0].transpose(1, 0, 2) for x in qkv(1, Sq, Skv, BH, d, seed))
    q, k, v = (_at_offset(x, dev, tdt, offset)
               for x in (q * np.float32(q_scale), k, v))
    if offset % (16 // q.element_size()):
        assert all(x.data_ptr() % 16 != 0 for x in (q, k, v))
    n, copies = _build.launches[key], _build.launches["flash_realign"]
    flash_ops.cluster_blocks_seen()
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
    assert _build.launches[key] == n + 1
    _clusters_seen(d, dtype, key == "flash_wide_cluster")
    assert _build.launches["flash_realign"] - copies == \
        _realigns(d, offset, dtype, Skv)
    torch.cuda.synchronize()
    ref = flash_ref.attention_f64 if f64 else flash_ref.attention_ref
    want = ref(q, k, v, causal=causal, window=window, softcap=softcap)
    assert got.dtype == tdt and got.shape == (BH, Sq, d)
    _held(got, want, dtype)


def test_flash_unaligned_base_takes_the_general_kernel():
    """A base that is not 16-byte aligned is out of TMA's reach: the
    general kernel takes it, counted as ``flash_general``."""
    _flash_folded(2, 96, 96, 64, "bfloat16", "flash_general")


@pytest.mark.parametrize("d", [1, 7, 64, 70, 128, 250, 256])
@pytest.mark.parametrize("offset", [1, 3])
def test_flash_general_head_dims(d, offset):
    """The general kernel's producer realigns rows that start at any even
    byte: odd and even element offsets, every compiled width, d % 8 != 0
    (rows whose offset changes from row to row)."""
    _flash_folded(2, 130, 197, d, "bfloat16", "flash_general", offset=offset,
                  window=48, softcap=50.0, seed=d)
    _flash_folded(2, 70, 197, d, "bfloat16", "flash_general", offset=offset,
                  causal=False, seed=d + 1)


@pytest.mark.parametrize("Sq,Skv,causal", EDGE_LENGTHS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_general_tile_edges(Sq, Skv, causal, d):
    """The Hopper kernel's tile edges on the general route."""
    _flash_folded(2, Sq, Skv, d, "bfloat16", "flash_general", causal=causal,
                  seed=Sq + Skv)


@pytest.mark.parametrize("window", [64, 100, 128])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_general_window_edges(window, d):
    _flash_folded(2, 512, 512, d, "bfloat16", "flash_general", window=window,
                  seed=window)


@pytest.mark.parametrize("window", [0, 256])
def test_flash_general_gemma2_softcap(window):
    """Gemma-2's widths and softcap on the general route, q 8x larger so
    the softcap changes the logits."""
    _flash_folded(2, 1024, 1024, 256, "bfloat16", "flash_general",
                  window=window, softcap=50.0, q_scale=8.0)


def test_flash_general_no_keys():
    """Skv = 0: TMA cannot describe it, the general kernel writes zeros,
    as the plain version does (acc / max(l, 1e-30))."""
    dev = need_card()
    q = torch.randn(3, 70, 64, device=dev).to(torch.bfloat16)
    k = torch.zeros(3, 0, 64, device=dev, dtype=torch.bfloat16)
    n = _build.launches["flash_general"]
    got = flash_ops.flash_attention(q, k, k, causal=False)
    assert _build.launches["flash_general"] == n + 1
    want = flash_ref.attention_ref(q, k, k, causal=False)
    assert torch.equal(got, torch.zeros_like(q)) and torch.equal(got, want)


def test_flash_general_many_heads():
    """B * H = 66,000 > 65,535 on the general route."""
    _flash_folded(66000, 16, 16, 32, "bfloat16", "flash_general")


@pytest.mark.parametrize("d", [1, 3, 70, 200, 256])
def test_flash_f32_head_dims(d):
    """float32 at widths that are no compiled width, odd ones (4-byte
    copies) included."""
    _flash_folded(2, 130, 197, d, "float32", "flash_f32", offset=0,
                  window=48, softcap=50.0, seed=d)
    _flash_folded(2, 70, 197, d, "float32", "flash_f32", offset=0,
                  causal=False, seed=d + 1)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_f32_base_past_a_16_byte_boundary(d):
    """A float32 base 4 bytes past a 16-byte boundary takes the 4-byte
    copies."""
    _flash_folded(2, 200, 300, d, "float32", "flash_f32", offset=1,
                  window=48, softcap=50.0, seed=d)


@pytest.mark.parametrize("Sq,Skv,causal", EDGE_LENGTHS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_f32_tile_edges(Sq, Skv, causal, d):
    _flash_folded(2, Sq, Skv, d, "float32", "flash_f32", offset=0,
                  causal=causal, seed=Sq + Skv)


@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_f32_softcap_large_logits(d, window):
    """Gemma-2's softcap with q 8x larger (logits up to about 40) over
    1,024 keys, held to the function in float64 (as the wide route's
    softcap test is): with a row's S and P V summed in one tensor-core
    accumulator (whose float32 sums do not round to nearest) the kernel
    was 5.2e-5 off float64 at d = 256 on an H100, past float32's 2e-5."""
    _flash_folded(2, 1024, 1024, d, "float32", "flash_f32", offset=0,
                  window=window, softcap=50.0, q_scale=8.0, seed=d, f64=True)


# float16: the Hopper and the general kernel at float16 (launch keys
# flash_f16 and flash_f16_general) over the shapes bf16 covers above
@pytest.mark.parametrize("Sq,Skv,causal", EDGE_LENGTHS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_f16_hopper_tile_edges(Sq, Skv, causal, d):
    _flash_case(1, Sq, Skv, 2, d, causal, 0, 0.0, "float16", seed=Sq + Skv,
                key="flash_f16")


@pytest.mark.parametrize("window", [64, 100, 128])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_f16_hopper_window_edges(window, d):
    _flash_case(1, 512, 512, 2, d, True, window, 0.0, "float16", seed=window,
                key="flash_f16")


@pytest.mark.parametrize("window", [0, 256])
def test_flash_f16_gemma2_softcap(window):
    """Gemma-2's widths and softcap at float16, q 8x larger so the softcap
    changes the logits: on the Hopper kernel and on the general one."""
    _flash_case(1, 1024, 1024, 2, 256, True, window, 50.0, "float16",
                q_scale=8.0, key="flash_f16")
    _flash_folded(2, 1024, 1024, 256, "float16", "flash_f16_general",
                  window=window, softcap=50.0, q_scale=8.0)


@pytest.mark.parametrize("d,key", [(72, "flash_f16"),
                                   (70, "flash_f16_general")])
def test_flash_f16_widths_route_by_shape(d, key):
    _flash_case(1, 200, 300, 2, d, True, 48, 50.0, "float16", seed=d,
                key=key)
    _flash_case(1, 70, 197, 2, d, False, 0, 0.0, "float16", seed=d, key=key)


@pytest.mark.parametrize("d", [1, 7, 64, 70, 128, 250, 256])
@pytest.mark.parametrize("offset", [1, 3])
def test_flash_f16_general_head_dims(d, offset):
    """The general kernel at float16 on bases an odd number of elements
    past a 16-byte boundary, d % 8 != 0 included."""
    _flash_folded(2, 130, 197, d, "float16", "flash_f16_general",
                  offset=offset, window=48, softcap=50.0, seed=d)
    _flash_folded(2, 70, 197, d, "float16", "flash_f16_general",
                  offset=offset, causal=False, seed=d + 1)


@pytest.mark.parametrize("Sq,Skv,causal", EDGE_LENGTHS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_f16_general_tile_edges(Sq, Skv, causal, d):
    _flash_folded(2, Sq, Skv, d, "float16", "flash_f16_general",
                  causal=causal, seed=Sq + Skv)


@pytest.mark.parametrize("window", [64, 100, 128])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_f16_general_window_edges(window, d):
    _flash_folded(2, 512, 512, d, "float16", "flash_f16_general",
                  window=window, seed=window)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_16_bit_no_keys_on_the_general_kernel(dtype):
    """Skv = 0 at d <= 256: TMA cannot describe it, the general kernel
    writes zeros at each 16-bit dtype, as the plain version does."""
    dev = need_card()
    tdt = FLASH_DTYPES[dtype]
    q = torch.randn(3, 70, 64, device=dev).to(tdt)
    k = torch.zeros(3, 0, 64, device=dev, dtype=tdt)
    n = _build.launches[GENERAL[dtype]]
    got = flash_ops.flash_attention(q, k, k, causal=False)
    assert _build.launches[GENERAL[dtype]] == n + 1
    want = flash_ref.attention_ref(q, k, k, causal=False)
    assert torch.equal(got, torch.zeros_like(q)) and torch.equal(got, want)


def test_flash_f16_general_many_heads():
    """B * H = 66,000 > 65,535 on the float16 general route."""
    _flash_folded(66000, 16, 16, 32, "float16", "flash_f16_general")


# d > 256: four routes at every dtype, chosen by shape.  flash_wide (S
# once a key tile for every output column) takes what TMA can describe up
# to d = 576 (ops.WIDE_MAXD): 16-byte aligned bases, d % 8 == 0, at least
# one key; flash_wide_cluster the same shapes up to d = 4096
# (ops.CLUSTER_MAXD), a cluster of blocks a query tile.  Up to 4096 after
# padding d to a multiple of 8, with at least one key, the wrapper first
# copies every other shape into padded, aligned scratch (flash_realign:
# one launch a tensor it copies, and one for the output where d % 8 != 0),
# then flash_wide or flash_wide_cluster takes it.  flash_wide_general
# takes the rest: d > 4096 after padding, Skv = 0.
WIDE_D = [257, 300, 512, 576, 1000, 2048, 2624, 4096, 4200]
WIDE_MAX = flash_ops.WIDE_MAXD
REACH = flash_ops.CLUSTER_MAXD


def _wide_key(d: int, offset: int = 0) -> str:
    """The wide kernel that runs for head dim ``d`` with at least one key
    at bases ``offset`` elements past a 16-byte boundary (0 for a fresh
    tensor): ``ops.wide_key``, behind flash_realign where the shape needs
    it (``_realigns``)."""
    return flash_ops.wide_key(d)


def _realigns(d: int, offset: int, dtype: str, Skv: int = 1) -> int:
    """flash_realign launches of one call whose q, k and v lie ``offset``
    elements past a 16-byte boundary: the three inputs where a base is not
    16-byte aligned or d % 8 != 0, and the output where d % 8 != 0, on the
    realigned route (256 < d, padded d <= ``REACH``, Skv > 0); else
    none."""
    if d <= 256 or flash_ops.padded(d) > REACH or Skv == 0:
        return 0
    unaligned = offset * FLASH_DTYPES[dtype].itemsize % 16 != 0
    return 3 * (unaligned or d % 8 != 0) + (d % 8 != 0)


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
@pytest.mark.parametrize("mode", ["causal-window-softcap", "cross"])
def test_flash_wide_head_dims(d, dtype, mode):
    """Widths past 256 (odd, d % 8 != 0, several output slices, 2048),
    the causal mask with a window and Gemma-2's softcap, and a ragged
    cross-attention shape, each on the route its shape picks (257 and 300
    on flash_wide behind flash_realign, 1000, 2048, 2624 and 4096 on
    flash_wide_cluster, 4200 on the general wide kernel)."""
    if mode == "cross":
        _flash_case(1, 70, 197, 2, d, False, 0, 0.0, dtype, seed=d,
                    key=_wide_key(d))
    else:
        _flash_case(1, 130, 130, 2, d, True, 48, 50.0, dtype, seed=d,
                    key=_wide_key(d))


@pytest.mark.parametrize("d", [257, 576, 584, 640, 1030, 4104])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_flash_wide_unaligned_bases(d, dtype, offset):
    """Bases 0, 1 and 3 elements past a 16-byte boundary: TMA describes
    only aligned ones with d % 8 == 0; up to 4096 the rest reach flash_wide
    (up to 576) or flash_wide_cluster on realigned scratch
    (flash_realign), each tensor copied, and at d = 1030 the output too
    (at float32, offset 3 is 12 bytes past a 16-byte boundary); past the
    reach (4104) the general wide kernel stages the unaligned rows
    itself."""
    key = _wide_key(d, offset)
    _flash_folded(2, 130, 197, d, dtype, key, offset=offset,
                  window=48, softcap=50.0, seed=d + offset)
    _flash_folded(2, 70, 197, d, dtype, key, offset=offset,
                  causal=False, seed=d + offset + 1)


@pytest.mark.parametrize("d,offset", [(WIDE_MAX, 0), (WIDE_MAX, 1),
                                      (WIDE_MAX + 8, 0), (WIDE_MAX + 8, 1),
                                      (264, 0), (512, 0), (REACH, 0),
                                      (REACH, 1), (REACH + 8, 0),
                                      (REACH + 8, 1)])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_route_boundary(d, offset, dtype):
    """The edges of the wide routes: flash_wide's widest head and the next
    multiple of 8 above it (flash_wide_cluster's narrowest), the cluster's
    widest (8 blocks) and the next multiple of 8
    (the general wide kernel's), each aligned and one element past an
    aligned base (realigned up to the reach), and two widths inside."""
    _flash_folded(2, 130, 197, d, dtype, _wide_key(d, offset),
                  offset=offset, window=48, softcap=50.0, seed=d + offset)


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_no_keys(dtype):
    """Skv = 0 above 256: TMA cannot describe it, the general wide kernel
    writes zeros, as the plain version does (acc / max(l, 1e-30))."""
    dev = need_card()
    tdt = FLASH_DTYPES[dtype]
    q = torch.randn(3, 70, 300, device=dev).to(tdt)
    k = torch.zeros(3, 0, 300, device=dev, dtype=tdt)
    n = _build.launches["flash_wide_general"]
    got = flash_ops.flash_attention(q, k, k, causal=False)
    assert _build.launches["flash_wide_general"] == n + 1
    want = flash_ref.attention_ref(q, k, k, causal=False)
    assert torch.equal(got, torch.zeros_like(q)) and torch.equal(got, want)


#: lengths on both sides of flash_wide's tiles: 64 query rows, 64 keys at
#: 16 bits and 96 at float32, each tile's keys split in halves (thirds at
#: float32) between the warps that compute S
WIDE_EDGE_LENGTHS = [(63, 63, True), (65, 65, True), (95, 97, False),
                     (97, 95, True), (191, 193, True), (1, 96, False),
                     (200, 33, False)]


@pytest.mark.parametrize("Sq,Skv,causal", EDGE_LENGTHS + WIDE_EDGE_LENGTHS)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_tile_edges(Sq, Skv, causal, dtype):
    """Ragged lengths on both sides of the wide kernels' tiles (flash_wide's
    and, for the first cases, the general wide kernel's 128 query rows and
    64 or 32 keys) at DeepSeek-V2's absorbed width 576, on flash_wide."""
    _flash_folded(2, Sq, Skv, 576, dtype, "flash_wide", offset=0,
                  causal=causal, seed=Sq + Skv)


@pytest.mark.parametrize("window", [32, 64, 100])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_window_edges(window, dtype):
    _flash_folded(2, 512, 512, 384, dtype, "flash_wide", offset=0,
                  window=window, seed=window)


@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_softcap(window, dtype):
    """The softcap at d = 576 with q 8x larger, so it changes the logits,
    on flash_wide.  At float32 the logits reach about 40, where float32's
    own rounding of them (and of tanh) moves the plain version, which
    computes in float32, by up to 2.3e-5 against float64
    (``kernels/flash/compare.py``), so kernel and plain version can differ
    by more than the 2e-5 contract: the kernel is held to the function
    computed in float64 there."""
    _flash_folded(2, 1024, 1024, 576, dtype, "flash_wide", offset=0,
                  window=window, softcap=50.0, q_scale=8.0,
                  f64=dtype == "float32")


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_many_heads(dtype):
    """B * H = 66,000: the flattened grid takes it on every wide route
    (flash_wide's one block a query tile, at an aligned base and behind
    flash_realign one element past it; at d = 584 flash_wide_cluster's
    clusters of 2 blocks a query tile, 132,000 blocks, behind
    flash_realign; past the reach, at d = 4104, the general wide kernel's
    17 output slices a head, 1,122,000 blocks, on bases one element past
    a 16-byte boundary, with one query and one key a head so the inputs
    stay near 1 GB at float32)."""
    _flash_folded(66000, 16, 16, 264, dtype, "flash_wide", offset=0)
    _flash_folded(66000, 16, 16, 264, dtype, _wide_key(264, 1), offset=1)
    _flash_folded(66000, 16, 16, 584, dtype, _wide_key(584, 1), offset=1)
    _flash_folded(66000, 1, 1, REACH + 8, dtype, "flash_wide_general",
                  offset=1)


@pytest.mark.parametrize("eb", [2, 4])
def test_cluster_blocks_rule_matches_the_emulation(eb):
    """flash.cu's own rule for the blocks a cluster (``ops.cluster_blocks``,
    read from the library) against the CPU emulation's model of it
    (``cluster_shares``) at every width the cluster route takes."""
    need_card()
    for d in range(WIDE_MAX + 8, REACH + 1, 8):
        assert flash_ops.cluster_blocks(d, eb) == len(cluster_shares(d, eb))


@pytest.mark.parametrize("d", [640, 1152, 2048, 2560, 3072, 3584, 4096])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_cluster_sizes(d, dtype):
    """Every cluster size the route launches, 2, 3, 4, 5, 6, 7 and 8 blocks
    at float32 (at 16 bits 6 and 7 run as 8), each read in the kernel
    (``_flash_folded`` holds it to ``cluster_shares``), the output held to
    the plain version."""
    _flash_folded(2, 130, 197, d, dtype, "flash_wide_cluster", offset=0,
                  window=48, softcap=50.0, seed=d)


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
@pytest.mark.parametrize("d,offset", [(300, 0), (576, 1), (575, 3)])
def test_flash_wide_realigned_k_is_v(dtype, d, offset):
    """k the same tensor as v on the realigned route: each is copied into
    its own scratch (no aliasing assumed), then one flash_wide launch."""
    dev = need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = FLASH_DTYPES[dtype]
    q, k, _ = (x[0].transpose(1, 0, 2) for x in qkv(1, 97, 130, 2, d, d))
    q, k = (_at_offset(x, dev, tdt, offset) for x in (q, k))
    before = {n: _build.launches[n] for n in ("flash_realign", "flash_wide")}
    got = flash_ops.flash_attention(q, k, k, causal=True, window=48,
                                    softcap=50.0)
    added = {n: _build.launches[n] - c for n, c in before.items()}
    assert added == {"flash_realign": _realigns(d, offset, dtype),
                     "flash_wide": 1}
    torch.cuda.synchronize()
    want = flash_ref.attention_ref(q, k, k, causal=True, window=48,
                                   softcap=50.0)
    _held(got, want, dtype)


#: lengths on both sides of flash_wide_cluster's tiles: 64 query rows, 64
#: keys at 16 bits and 96 at float32
CLUSTER_EDGE_LENGTHS = [(63, 63, True), (65, 65, True), (97, 95, True),
                        (191, 193, True), (1, 96, False), (200, 33, False),
                        (129, 1000, False)]


@pytest.mark.parametrize("Sq,Skv,causal", CLUSTER_EDGE_LENGTHS)
@pytest.mark.parametrize("d", [640, 1024, 1152])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_cluster_tile_edges(Sq, Skv, causal, d, dtype):
    """Ragged lengths on both sides of the cluster kernels' tiles, at two
    blocks a query tile (d = 640 and 1024: the one-round exchange at 16
    bits) and three (1152: the two-round exchange)."""
    _flash_folded(2, Sq, Skv, d, dtype, "flash_wide_cluster", offset=0,
                  causal=causal, seed=Sq + Skv + d)


@pytest.mark.parametrize("window", [32, 64, 100])
@pytest.mark.parametrize("d", [640, 1024, 1152])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_cluster_window_edges(window, d, dtype):
    _flash_folded(2, 512, 512, d, dtype, "flash_wide_cluster", offset=0,
                  window=window, seed=window + d)


@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("d", [640, 1024, 1152])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_cluster_softcap(window, d, dtype):
    """The softcap with q 8x larger on flash_wide_cluster; at float32 held
    to the function computed in float64, as ``test_flash_wide_softcap``
    is (the plain version's own rounding of logits near 40)."""
    _flash_folded(2, 1024, 1024, d, dtype, "flash_wide_cluster", offset=0,
                  window=window, softcap=50.0, q_scale=8.0,
                  f64=dtype == "float32")


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_wide_cluster_no_keys_takes_the_general_kernel(dtype):
    """Skv = 0 at d = 1024: TMA cannot describe it, so the general wide
    kernel takes it and writes zeros, as the plain version does."""
    dev = need_card()
    tdt = FLASH_DTYPES[dtype]
    q = torch.randn(3, 70, 1024, device=dev).to(tdt)
    k = torch.zeros(3, 0, 1024, device=dev, dtype=tdt)
    before = {n: _build.launches[n] for n in FLASH_KEYS[dtype]}
    got = flash_ops.flash_attention(q, k, k, causal=False)
    added = {n: _build.launches[n] - c for n, c in before.items()
             if _build.launches[n] != c}
    assert added == {"flash_wide_general": 1}
    assert torch.equal(got, torch.zeros_like(q))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("d", [257, 300, 575, 576, 3])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_realign_matches_plain(d, dtype):
    """The realigning copy against its plain version, bit for bit, at every
    element offset past a 16-byte boundary (1-7 at 16 bits, 1-3 at
    float32) and at 0, on 3 x 700 rows (several blocks): ``pad8`` from a
    source at the offset into fresh, aligned scratch, ``unpad8`` back into a
    fresh tensor (its rows start at any element boundary where d % 8 !=
    0), and the reverse copy into a destination at the offset, inside a
    buffer whose other bytes it must leave alone; one flash_realign launch
    each."""
    dev = need_card()
    tdt = FLASH_DTYPES[dtype]
    eb = tdt.itemsize
    rng = np.random.default_rng(d)
    x0 = rng.standard_normal((3, 700, d)).astype(np.float32)
    for offset in range(16 // eb):
        x = _at_offset(x0, dev, tdt, offset)
        n = _build.launches["flash_realign"]
        p = flash_ops.pad8(x)
        assert _build.launches["flash_realign"] == n + 1
        assert p.data_ptr() % 16 == 0 and p.shape == (3, 700, flash_ops.padded(d))
        assert torch.equal(_bits(p), _bits(flash_ref.pad8_ref(x)))
        back = flash_ops.unpad8(p, d)
        assert _build.launches["flash_realign"] == n + 2
        assert torch.equal(_bits(back), _bits(x))
        # the reverse copy into a base at the offset, 16 elements of
        # sentinel on either side
        buf = torch.full((x.numel() + offset + 16,), -7.0, dtype=tdt,
                         device=dev)
        dst = buf[offset:offset + x.numel()].view(x.shape)
        _build.launch("flash_realign", "repro_flash_realign", p, dst,
                      3 * 700, d, eb, 1)
        torch.cuda.synchronize()
        assert torch.equal(_bits(dst), _bits(x))
        rest = torch.cat([buf[:offset], buf[offset + x.numel():]])
        assert bool((rest == -7.0).all())


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_realign_refuses_misaligned_scratch(dtype):
    """The copy refuses an aligned side that is not 16-byte aligned: the
    wrapper raises and counts nothing."""
    dev = need_card()
    tdt = FLASH_DTYPES[dtype]
    x = torch.zeros(4, 300, dtype=tdt, device=dev)
    bad = torch.empty(4 * 304 + 1, dtype=tdt, device=dev)[1:].view(4, 304)
    n = _build.launches["flash_realign"]
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.launch("flash_realign", "repro_flash_realign", x, bad, 4, 300,
                      tdt.itemsize, 0)
    assert _build.launches["flash_realign"] == n


@pytest.mark.parametrize("causal", [False, True])
def test_flash_hopper_negative_scale(causal):
    """An explicit negative scale, with logits spread over hundreds (q
    drawn 4x larger): the Hopper kernel's interior tiles may take the max
    of the raw dots only for a positive scale, or p overflows."""
    dev = need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = qkv(1, 512, 512, 2, 128, 3)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        x[0].transpose(1, 0, 2))).to(dev, torch.bfloat16)
        for x in (q * np.float32(4.0), k, v))
    n = _build.launches["flash"]
    got = flash_ops.flash_attention(q, k, v, causal=causal, scale=-1.0)
    assert _build.launches["flash"] == n + 1
    want = flash_ref.attention_ref(q, k, v, causal=causal, scale=-1.0)
    assert bool(torch.isfinite(got).all())
    tol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_chunked_attention(window, dtype):
    """K5 against the model layer's chunked attention at Gemma-2 smoke
    widths (4 heads, 2 KV heads through ``repeat_kv``, head dim 16, attn
    softcap 50, chunks of 16; the local layer's window 8 and a global
    layer)."""
    dev = need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, Hkv, d = 2, 64, 4, 2, 16
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, S, H, d)).astype(
        np.float32)).to(dev, FLASH_DTYPES[dtype])
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, d)).astype(
        np.float32)).to(dev, FLASH_DTYPES[dtype]) for _ in range(2))
    k, v = layers.repeat_kv(k, H // Hkv), layers.repeat_kv(v, H // Hkv)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    want = layers.chunked_attention(q, k, v, pos, pos, causal=True,
                                    window=window, softcap=50.0,
                                    scale=d ** -0.5, q_chunk=16,
                                    kv_chunk=16)
    got = flash_ops.attention(q, k, v, causal=True, window=window,
                              softcap=50.0)
    tol = 3e-5 if dtype == "float32" else FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# K1 in float64: the band and tile edges of the 4-byte kernel (an 8-byte
# entry takes 128 columns a chunk), many frames, and integer loads up to
# 2**30 whose sums stay exact in float64 (tolerance: none)
@pytest.mark.parametrize("shape", [
    (1, 1), (7, 9), (3, 17, 130), (4, 0, 5), (2, 5, 0), (3, 130, 200),
    (5, 1, 1), (2, 1, 700), (2, 700, 1), (2, 65, 127), (2, 65, 129),
    (2, 300, 1030), (1, 4480, 3), (1, 1000, 37), (64, 512, 512),
    (300, 33, 17)])
def test_sat_kernel_float64_matches_plain(shape):
    dev = need_card()
    a = torch.from_numpy(_small_int_loads(shape, 2 ** 30, seed=3)).to(
        dev, torch.float64)
    before = {k: _build.launches[k] for k in SAT_KEYS}
    got = sat_ops.gamma(a)
    assert {k: _build.launches[k] - n for k, n in before.items()} == \
        {k: int(k == "sat") for k in SAT_KEYS}
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert torch.equal(got, sat_ref.gamma_ref(a))


def test_sat_kernel_float64_off_integers():
    """Loads that are not integers (multiples of 2**-20): float64 holds
    every partial sum exactly here too, so the kernel equals the exact
    prefix taken in int64 and scaled, whatever its order of sums."""
    dev = need_card()
    rng = np.random.default_rng(4)
    ints = rng.integers(0, 2 ** 20, (4, 300, 260))
    a = torch.from_numpy(ints / 2 ** 20).to(dev)
    exact = sat_ref.gamma_ref(torch.from_numpy(ints).to(dev)).double()
    exact /= 2 ** 20
    assert torch.equal(sat_ops.gamma(a), exact)


def test_gamma3_kernel_refuses_float64():
    """Named for the refusal it held until K4 took float64: a float64
    Gamma3 on the card now equals the exact prefix, and float16 is still
    refused."""
    dev = need_card()
    a = torch.from_numpy(_small_int_loads((2, 3, 4), 2 ** 30)).to(dev)
    assert torch.equal(sat_ops.gamma3(a.double()),
                       _exact_gamma(a, 3).double())
    with pytest.raises(TypeError, match="float32 or int32 or float64"):
        sat_ops.gamma3(torch.zeros((2, 3, 4), dtype=torch.float16,
                                   device=dev))


# K4 in float64 (8-byte entries: classes 1, 2 and 4, one slab in flight):
# each class's widest and tallest plane and one past it (the general
# route), band edges, empty slabs and planes, and the float64 path's
# 128^3 volumes; integer loads up to 2**30, exact in float64 (tolerance:
# none, against the plain version and the exact int64 prefix)
@pytest.mark.parametrize("shape,key", [
    ((1, 1, 1), "sat3"), ((5, 7, 9), "sat3"), ((2, 40, 29, 3), "sat3"),
    ((2, 0, 4, 5), "sat3"), ((3, 6, 0, 2), "sat3"), ((1, 200, 3, 70), "sat3"),
    ((16, 130, 17, 19), "sat3"), ((1, 301, 5, 7), "sat3"),
    ((1, 5, 512, 32), "sat3"), ((1, 5, 513, 32), "sat3_general"),
    ((2, 9, 256, 64), "sat3"), ((2, 9, 257, 64), "sat3_general"),
    ((2, 3, 128, 128), "sat3"), ((2, 3, 129, 128), "sat3_general"),
    ((2, 3, 16, 129), "sat3_general"), ((3, 17, 33, 130), "sat3_general"),
    ((2, 3, 64, 256), "sat3_general"), ((2, 5, 20, 300), "sat3_general"),
    ((16, 128, 128, 128), "sat3"), ((1, 128, 128, 128), "sat3")])
def test_sat3_kernel_float64_matches_plain(shape, key):
    dev = need_card()
    a64 = torch.from_numpy(_small_int_loads(shape, 2 ** 30, seed=5)).to(dev)
    a = a64.double()
    before = {k: _build.launches[k] for k in SAT_KEYS}
    got = sat_ops.gamma3(a)
    assert {k: _build.launches[k] - n for k, n in before.items()} == \
        {k: int(k == key) for k in SAT_KEYS}
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert torch.equal(got, sat_ref.gamma3_ref(a))
    assert torch.equal(got, _exact_gamma(a64, 3).double())


def test_sharded_planner_on_card_matches_one_device():
    """A mesh naming the card twice (``[cuda] * 2``, ragged T) plans the
    2D heuristic, the exact path and the 3D path bit-identically to the
    single-device call, and the result lands on the card."""
    from repro_torch.dist import ctx
    dev = need_card()
    mesh = ctx.planner_mesh(devices=[dev] * 2)
    fr = stream.drifting_hotspot(7, 48, 64, seed=5)
    for exact in (False, True):
        got = planner.plan_stream(fr, P=4, m=16, exact=exact, mesh=mesh)
        want = planner.plan_stream(fr, P=4, m=16, exact=exact, device=dev)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a, b)
    vol = stream.pic_series_3d(5, 14, 16, 18, seed=5)
    for gd in (torch.float32, torch.float64):
        got = planner.plan_stream_3d(vol, m=12, mesh=mesh, gamma_dtype=gd)
        want = planner.plan_stream_3d(vol, m=12, device=dev, gamma_dtype=gd)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_execute_migration_on_card_entries_matches_ledger():
    """Processors on three entries of the card: the receipts equal the
    one-device receipts and the priced ledger, ``device_of`` is
    ``arange(m) % 3``."""
    from repro_torch.rebalance import execute, migrate
    dev = need_card()
    fr = stream.drifting_hotspot(3, 40, 40, seed=2)
    plans = planner.plan_host(fr, P=4, m=12, device=dev)
    r = execute.execute_migration(plans[0], plans[1], fr[1],
                                  devices=[dev] * 3)
    one = execute.execute_migration(plans[0], plans[1], fr[1], device=dev)
    assert r.executed_bytes == one.executed_bytes == \
        migrate.migration_volume(plans[0], plans[1], fr[1])
    np.testing.assert_array_equal(r.pair_bytes, one.pair_bytes)
    np.testing.assert_array_equal(r.device_of, np.arange(12) % 3)
    execute.verify_receipt(plans[0], plans[1], fr[1], receipt=r)


def _pic_above_2_24(T, n1, n2):
    fr = stream.pic_series(T, n1, n2, seed=1) * 2 ** 10
    assert fr.reshape(T, -1).sum(axis=1).min() > 2 ** 24
    return fr


@pytest.mark.parametrize("T,n1,n2,P,m", [(3, 40, 48, 4, 16),
                                         (4, 200, 130, 8, 64)])
def test_float64_planner_on_card_matches_cpu(T, n1, n2, P, m):
    """The float64 plan path (K1 in float64, the float64 heuristic) on the
    card equals the CPU path bit for bit above 2**24, and its Lmax is the
    exact int64 bottleneck of each plan."""
    dev = need_card()
    fr = _pic_above_2_24(T, n1, n2)
    before = _build.launches["sat"]
    got = planner.plan_stream(fr, P=P, m=m, gamma_dtype=torch.float64,
                              device=dev)
    assert _build.launches["sat"] == before + 1
    want = planner.plan_stream(fr, P=P, m=m, gamma_dtype=torch.float64,
                               device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    from repro_torch.rebalance import batch_device
    for t, pl in enumerate(batch_device.unstack_plans(got, (n1, n2))):
        g = prefix.prefix_sum_2d(fr[t])
        assert float(got[3][t]) == float(pl.loads(g).max())


def _ledger_policies():
    from repro_torch.rebalance import policy
    return {"never": policy.NeverRebalance(),
            "always": policy.AlwaysRebalance(), "every4": policy.EveryK(4),
            "hysteresis": policy.HysteresisPolicy(),
            "two-phase": policy.TwoPhaseHysteresis(),
            "fault-aware": policy.FaultAwareHysteresis()}


@pytest.mark.parametrize("name", ["drifting_hotspot", "pic_series",
                                  "refinement_bursts"])
@pytest.mark.parametrize("scenario", [None, "random-failures",
                                      "rack-failure"])
def test_runtime_on_card_matches_cpu(name, scenario):
    """``compare_policies`` (every policy) and a lazy ``run_stream`` on the
    card: the ledgers equal the CPU path's."""
    from _torch_parity import ledger_diff
    from repro_torch.rebalance import faults, policy, runtime
    dev = need_card()
    fr = getattr(stream, name)(16, 48, 48, seed=0)
    sched = None if scenario is None else \
        faults.FAULT_SCENARIOS[scenario](16, 16, seed=0)
    kw = dict(P=4, m=16, alpha=0.25, replan_overhead=1000.0, faults=sched,
              validate=True)
    got = runtime.compare_policies(fr, _ledger_policies(), device=dev, **kw)
    want = runtime.compare_policies(fr, _ledger_policies(), device="cpu",
                                    **kw)
    for k in got:
        assert ledger_diff(got[k], want[k]) == [], k
    one = runtime.run_stream(fr, policy.FaultAwareHysteresis(), device=dev,
                             **kw)
    assert ledger_diff(one, want["fault-aware"]) == []


@pytest.mark.parametrize("scenario", ["random-failures", "rack-failure",
                                      "hand"])
def test_run_stream_executes_on_card_as_priced(scenario):
    """``run_stream(execute=True)`` on the card under a fault schedule:
    every replan's executed bytes equal its priced migration volume, the
    failures force replans, rectangle pricing ran K3, and the ledger
    equals the CPU path's."""
    from _torch_parity import ledger_diff
    from repro_torch.rebalance import faults, policy, runtime
    dev = need_card()
    T, m = 16, 16
    fr = stream.refinement_bursts(T, 48, 48, seed=0)
    if scenario == "hand":
        sched = faults.FaultSchedule(m, [
            faults.FaultEvent(T // 3, 3, "fail"),
            faults.FaultEvent(T // 2, 11, "fail"),
            faults.FaultEvent(T // 2, 7, "straggle", speed=0.3),
            faults.FaultEvent(2 * T // 3, 3, "recover")])
    else:
        sched = faults.FAULT_SCENARIOS[scenario](T, m, seed=0)
    kw = dict(P=4, m=m, alpha=0.25, replan_overhead=1000.0, faults=sched,
              validate=True, execute=True)
    before = dict(_build.launches)
    got = runtime.run_stream(fr, policy.FaultAwareHysteresis(), device=dev,
                             **kw)
    assert _build.launches["rectload"] > before.get("rectload", 0)
    assert _build.launches["sat"] > before.get("sat", 0)
    replans = [r for r in got.records[1:] if r.replanned]
    assert replans and all(r.executed_bytes == r.migration_volume
                           for r in replans)
    fails = sorted({e.step for e in sched.events if e.kind == "fail"})
    assert [r.step for r in got.records if r.forced] == fails
    want = runtime.run_stream(fr, policy.FaultAwareHysteresis(),
                              device="cpu", **kw)
    assert ledger_diff(got, want) == []


@pytest.mark.parametrize("arch", ["gemma2_9b", "internvl2_2b",
                                  "mixtral_8x7b", "deepseek_v2_236b",
                                  "mamba2_1_3b", "hymba_1_5b",
                                  "whisper_large_v3"])
def test_model_on_card_matches_cpu(arch, monkeypatch):
    """A dense (gemma2: local and global layers, softcaps, post-norms), a
    VLM, the two MoE smoke models (mixtral: GQA with a window of 8;
    deepseek: MLA, absorbed decode, shared experts), the SSM, the hybrid
    and the encoder-decoder at float32: ``forward`` (logits and ``aux``;
    ``decode_train`` for the encoder-decoder), ``prefill`` (logits and the
    cache: attention, the SSM's state and conv tail, the encoder states)
    and two decode steps on the card against the port's CPU path, within
    1e-4 x max |CPU|; the cache's positions, and every MoE call's expert
    ids and capacity slots, equal.  The model path launches none of the
    port's kernels, as the reference's calls none."""
    dev = need_card()
    cfg = configs.get_smoke(arch).scaled(dtype="float32")
    mod = encdec if cfg.family == "encdec" else lm
    cpu = mod.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    card = _to(cpu, dev)
    rng = np.random.default_rng(0)
    B, S = 2, 21
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {"vlm": cfg.vision_len, "encdec": cfg.encoder_len}
    pe = (rng.standard_normal((B, extra[cfg.family], cfg.d_model)).astype(
        np.float32) if cfg.family in extra else None)
    T = S + cfg.vision_len
    routes, route = [], layers.moe_route
    monkeypatch.setattr(layers, "moe_route", lambda p, c, xg: routes.append(
        route(p, c, xg)) or routes[-1])

    def run(params, device):
        cache = mod.init_cache(cfg, B, T + 4, device=device)
        if cfg.family == "encdec":
            full = encdec.decode_train(params, cfg, pe, toks, device=device)
            pre, cache = encdec.prefill(params, cfg, pe, toks, cache,
                                        device=device)
            outs = [full, pre]
        else:
            full, aux = lm.forward(params, cfg, toks, pe, device=device)
            pre, cache = lm.prefill(params, cfg, toks, cache, pe,
                                    device=device)
            outs = [full, aux, pre]
        for t in range(2):
            tok = outs[-1][:, -1].argmax(-1).int()[:, None]
            d, cache = mod.decode_step(params, cfg, tok,
                                       torch.full((B,), T + t), cache,
                                       device=device)
            outs.append(d)
        return outs, _flat(cache)

    before = sum(_build.launches.values())
    got, got_cache = run(card, dev)
    assert sum(_build.launches.values()) == before
    n = len(routes)
    want, want_cache = run(cpu, "cpu")
    assert len(routes) == 2 * n == (8 * cfg.n_layers if cfg.n_experts else 0)
    for a, b in zip(routes[:n], routes[n:]):
        assert torch.equal(a.ids.cpu(), b.ids)
        assert torch.equal(a.slots.cpu(), b.slots)
    assert set(got_cache) == set(want_cache)
    for k in got_cache:
        if k.endswith("pos"):
            assert torch.equal(got_cache[k].cpu(), want_cache[k])
        else:
            got.append(got_cache[k])
            want.append(want_cache[k])
    for g, w in zip(got, want):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


def _flat(tree, path=""):
    """A cache tree's tensors by path (``attn.k``, ``ssm.state``, ``enc``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}{key}.").items()}
    return {path[:-1]: tree}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _by_path(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _by_path(sub, f"{path}/{key}").items()}
    return {path: tree}


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mixtral_8x7b",
                                  "whisper_large_v3"])
def test_train_step_on_card_matches_cpu(arch):
    """One smoke train step (``launch.steps.make_train_step``,
    ``launch.train``'s AdamW defaults) from the same float32 parameters on
    the card and on the CPU: the loss and ``grad_norm`` within 1e-5
    relative, every leaf's first moment (0.1 x the clipped gradient)
    within 1e-4 x its max |CPU|, and the update within 1e-2 x lr wherever
    the two gradients agree within 1% (at step 1 AdamW moves an entry by
    about lr x sign(g), so a gradient at the float32 noise floor may move
    it the other way).  The training path launches none of the port's
    kernels."""
    from repro_torch.data import pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optim
    dev = need_card()
    cfg = configs.get_smoke(arch).scaled(dtype="float32")
    mod = encdec if cfg.family == "encdec" else lm
    cpu = mod.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=20)
    step = make_train_step(cfg, opt_cfg)
    batch = pipeline.TokenPipeline(cfg, pipeline.DataConfig(
        global_batch=2, seq_len=64)).batch_at(0)
    before = sum(_build.launches.values())
    card = _to(cpu, dev)
    pc, sc, mc = step(card, optim.init(opt_cfg, card, device=dev), batch,
                      device=dev)
    assert sum(_build.launches.values()) == before
    pp, sp, mp = step(cpu, optim.init(opt_cfg, cpu, device="cpu"), batch,
                      device="cpu")
    for k in ("loss", "grad_norm"):
        assert float(mc[k]) == pytest.approx(float(mp[k]), rel=1e-5), k
    lr = float(mp["lr"])
    m_card, m_cpu = _by_path(sc["m"]), _by_path(sp["m"])
    p_card, p_cpu, p0 = _by_path(pc), _by_path(pp), _by_path(cpu)
    for k, mw in m_cpu.items():
        mk = m_card[k].cpu()
        assert float((mk - mw).abs().max()) <= 1e-4 * float(
            mw.abs().max()), k
        agree = (mk - mw).abs() <= 0.01 * mw.abs()
        d = ((p_card[k].cpu() - p0[k]) - (p_cpu[k] - p0[k])).abs()[agree]
        assert not d.numel() or float(d.max()) <= 1e-2 * lr, k


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "deepseek_v2_236b",
                                  "mamba2_1_3b", "whisper_large_v3"])
def test_sharded_steps_on_card_match_unmeshed(arch):
    """``launch.steps.build_train`` (two steps), ``build_prefill`` and two
    ``build_decode`` steps on the card's ``make_local_mesh()`` and on a
    (2, 2) mesh that names the card four times: every output and cache
    tensor equal to the unmeshed path on the card (``make_train_step``,
    ``models.api``), bit for bit; no kernel launched."""
    from repro_torch.data import pipeline
    from repro_torch.dist import ctx
    from repro_torch.launch import cells, mesh, steps
    from repro_torch.models import api
    from repro_torch.train import optim
    dev = need_card()
    cfg = configs.get_smoke(arch).scaled(dtype="float32")
    ov = dataclasses.asdict(cfg)
    meshes = [mesh.make_local_mesh(),
              ctx.Mesh(((dev, dev), (dev, dev)), ("data", "model"))]
    model = api.build(cfg)
    p0 = model.init(torch.Generator().manual_seed(0), device=dev)
    oc = optim.AdamWConfig(lr=3e-3, warmup_steps=5)
    data = pipeline.TokenPipeline(cfg, pipeline.DataConfig(global_batch=4,
                                                           seq_len=48))
    before = sum(_build.launches.values())

    def train(step):
        p, s = p0, optim.init(oc, p0, device=dev)
        for i in range(2):
            p, s, m = step(p, s, data.batch_at(i))
        return _by_path({"p": p, "s": s, "m": m})

    def serve(prefill, decode):
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 50)),
                               dtype=torch.int32, device=dev)
        batch = {"tokens": toks[:, :48]}
        if cfg.family == "encdec":
            batch["frames"] = torch.as_tensor(rng.standard_normal(
                (4, cfg.encoder_len, cfg.d_model)), dtype=torch.float32,
                device=dev)
        cache = model.init_cache(4, 64, device=dev)
        out = {"prefill": prefill(p0, batch, cache)[0]}
        for i in range(2):
            out[f"decode{i}"] = decode(p0, toks[:, 48 + i:49 + i], torch.full(
                (4,), 48 + i, dtype=torch.int32, device=dev), cache)[0]
        return _by_path({"out": out, "cache": cache})

    plain = steps.make_train_step(cfg, oc)
    want_t = train(lambda p, s, b: plain(p, s, b, device=dev))
    want_s = serve(lambda p, b, c: model.prefill(p, b, c, device=dev),
                   lambda p, t, q, c: model.decode(p, t, q, c, device=dev))
    for m in meshes:
        fn, _ = steps.build_train(arch, cells.Shape("t", "train", 48, 4), m,
                                  opt_cfg=oc, overrides=ov)
        got = train(fn)
        assert set(got) == set(want_t)
        for k in got:
            assert torch.equal(got[k], want_t[k]), (m.shape, k)
        pf, _ = steps.build_prefill(arch, cells.Shape("p", "prefill", 48, 4),
                                    m, overrides=ov)
        dc, _ = steps.build_decode(arch, cells.Shape("d", "decode", 64, 4),
                                   m, overrides=ov)
        got = serve(pf, dc)
        for k in got:
            assert torch.equal(got[k], want_s[k]), (m.shape, k)
    assert sum(_build.launches.values()) == before
