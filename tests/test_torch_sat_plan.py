"""The SAT kernels' plans (``repro_torch.kernels.sat.ops``), on the CPU.

K1 and K4 cut the frames into bands and carry sums from band to band
(``sat_scan.cuh``); the wrapper chooses the bands, K4's route and the
scratch.  The kernels run only on the card (``test_torch_card.py``); here
the plans are checked, and the band decomposition the kernels compute is
replayed in int64 with the plans' own band heights and held against the
plain versions bit for bit (tolerance: none, integer loads).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.kernels.sat import ref as sat_ref

SMS = 132  # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("F,rows", [(1, 1), (1, 512), (16, 512), (64, 512),
                                    (3, 130), (2, 700), (1, 4480),
                                    (1, 10 ** 6), (640, 40)])
def test_band_rows_are_tile_multiples_that_cover_the_rows(F, rows):
    R = sat_ops.band_rows(F, rows, SMS)
    assert R % sat_ops.TILE_ROWS == 0
    assert sat_ops.TILE_ROWS <= R <= sat_ops.BAND_ROWS_MAX
    bands = -(-rows // R)
    assert (bands - 1) * R < rows <= bands * R
    # enough blocks to fill the card where the rows allow it
    assert F * bands >= min(SMS, F * -(-rows // sat_ops.TILE_ROWS))


@pytest.mark.parametrize("shape,route,c", [
    ((16, 128, 128, 128), "sat3", 4), ((1, 128, 128, 128), "sat3", 4),
    ((1, 1, 1, 1), "sat3", 1), ((5, 7, 9, 1), "sat3", 1),
    ((3, 17, 33, 130), "sat3", 8), ((2, 40, 29, 3), "sat3", 1),
    ((2, 0, 4, 5), "sat3", 1), ((3, 6, 0, 2), "sat3", 1),
    ((1, 200, 3, 70), "sat3", 4), ((2, 3, 64, 256), "sat3", 8),
    ((1, 5, 512, 32), "sat3", 1), ((2, 9, 100, 70), "sat3", 4),
    ((2, 5, 20, 300), "sat3_general", 0),
    ((1, 3, 600, 17), "sat3_general", 0),
    ((2, 4, 70, 130), "sat3_general", 0),
    ((2, 128, 128, 300), "sat3_general", 0)])
def test_sat3_plan_routes_by_plane(shape, route, c):
    got, cls, band = sat_ops.sat3_plan(*shape, SMS)
    assert (got, cls) == (route, c)
    B, n1, n2, n3 = shape
    if route == "sat3":
        assert n3 <= 32 * c and n2 <= 512 // c
        assert 1 <= band and B * -(-max(n1, 1) // band) <= max(SMS, B)
    else:
        assert band == sat_ops.band_rows(B * n1, n2, SMS)


@pytest.mark.parametrize("shape,route,c", [
    ((16, 128, 128, 128), "sat3", 4), ((1, 1, 1, 1), "sat3", 1),
    ((1, 5, 512, 32), "sat3", 1), ((1, 5, 513, 32), "sat3_general", 0),
    ((2, 9, 256, 64), "sat3", 2), ((2, 9, 257, 64), "sat3_general", 0),
    ((1, 200, 3, 70), "sat3", 4), ((2, 3, 128, 128), "sat3", 4),
    ((2, 3, 129, 128), "sat3_general", 0),
    ((2, 3, 16, 129), "sat3_general", 0),
    ((3, 17, 33, 130), "sat3_general", 0),
    ((2, 3, 64, 256), "sat3_general", 0),
    ((2, 128, 128, 300), "sat3_general", 0)])
def test_sat3_plan_routes_float64_by_plane(shape, route, c):
    """At 8 bytes an entry K4 has the classes 1, 2 and 4 (the widest
    class's block would not fit the card's shared memory), each with the
    float32 class's plane rows, so the float64 path's 128^3 volumes keep
    the fast route and planes with n3 > 128 take the general one."""
    got, cls, band = sat_ops.sat3_plan(*shape, SMS, itemsize=8)
    assert (got, cls) == (route, c)
    assert cls in (0,) + sat_ops.SAT3_CLASSES_8
    B, n1, n2, n3 = shape
    if route == "sat3":
        assert n3 <= 32 * c and n2 <= 512 // c
        assert band == sat_ops.sat3_plan(*shape, SMS)[2]
    else:
        assert band == sat_ops.band_rows(B * n1, n2, SMS)


def test_sat3_f64_scan_fits_a_block():
    """The scan block's shared memory at each class, as sat3d.cu's
    launch_band3 sizes it: tb [2][NW + 1][CW] float64 carries, stage
    [NW][CW] and ring [NST][TR][CW] entries, within the H100's 232,448
    bytes a block; two slabs in flight would not fit at 8 bytes."""
    def smem(item, c, nst):
        nw, cw, tr = (16 if c == 8 else 32), 32 * c, 512 // c
        return 8 * 2 * (nw + 1) * cw + item * (nw + nst * tr) * cw
    limit = 232448
    for c in sat_ops.SAT3_CLASSES:
        assert smem(4, c, 2) <= limit
    for c in sat_ops.SAT3_CLASSES_8:
        assert smem(8, c, 1) <= limit < smem(8, c, 2)
    assert smem(8, 8, 1) > limit


def test_sat3_plan_gives_one_block_per_sm_on_the_path():
    """16 volumes of 128^3: 8 bands of 16 slabs, 128 blocks on 132 SMs."""
    assert sat_ops.sat3_plan(16, 128, 128, 128, SMS) == ("sat3", 4, 16)


@pytest.mark.parametrize("rows,R,subs", [(512, 128, 12), (512, 64, 14),
                                         (130, 64, 4), (1, 64, 0),
                                         (0, 64, 0), (300, 16, 18)])
def test_scratch_holds_every_sub_band_above_the_last_band(rows, R, subs):
    for dt, acc in ((torch.float32, torch.float64),
                    (torch.int32, torch.int32),
                    (torch.float64, torch.float64)):
        E = sat_ops._sums(torch.zeros(1, dtype=dt), 3, rows, R, 7)
        assert E.shape == (3, subs, 7) and E.dtype == acc


def _loads(shape, seed=0, high=100):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, high, shape))


def _k1_by_bands(a: torch.Tensor, R: int) -> torch.Tensor:
    """K1's decomposition in int64: E = the column sums above each band,
    Gamma's row above the band = the row prefix of E, then the band's own
    2D prefix on top."""
    B, n1, n2 = a.shape
    g = torch.zeros((B, n1 + 1, n2 + 1), dtype=torch.int64)
    for r0 in range(0, n1, R):
        E = a[:, :r0].sum(dim=1)                      # the reduce
        V = torch.cumsum(E, dim=-1)                   # Gamma row r0
        band = sat_ref.sat_ref(a[:, r0:r0 + R])       # the scan
        g[:, r0 + 1:r0 + R + 1, 1:] = V[:, None] + band
    return g


@pytest.mark.parametrize("shape", [(3, 130, 200), (2, 700, 1), (1, 1, 9),
                                   (64, 512, 40), (4, 0, 5), (2, 65, 131)])
def test_k1_band_decomposition_is_gamma(shape):
    a = _loads(shape)
    R = sat_ops.band_rows(shape[0], shape[1], SMS)
    assert torch.equal(_k1_by_bands(a, R), sat_ref.gamma_ref(a))


def _k4_by_bands(a: torch.Tensor, S: int) -> torch.Tensor:
    """K4's decomposition in int64: the running plane starts at the sum of
    the slabs above the band (the reduce), each slab adds itself, and each
    Gamma3 plane is the running plane's 2D prefix (the scan)."""
    B, n1, n2, n3 = a.shape
    g = torch.zeros((B, n1 + 1, n2 + 1, n3 + 1), dtype=torch.int64)
    for s0 in range(0, n1, S):
        run = a[:, :s0].sum(dim=1)
        for s in range(s0, min(s0 + S, n1)):
            run = run + a[:, s]
            g[:, s + 1, 1:, 1:] = sat_ref.sat_ref(run)
    return g


def _k4_general(a: torch.Tensor) -> torch.Tensor:
    """K4's general route in int64: the slab prefix of every (j, k) entry,
    then K1 on every plane."""
    B, n1, n2, n3 = a.shape
    slabs = torch.cumsum(a, dim=1).reshape(B * n1, n2, n3)
    R = sat_ops.band_rows(B * n1, n2, SMS)
    g = torch.zeros((B, n1 + 1, n2 + 1, n3 + 1), dtype=torch.int64)
    g[:, 1:] = _k1_by_bands(slabs, R).reshape(B, n1, n2 + 1, n3 + 1)
    return g


@pytest.mark.parametrize("shape", [(16, 130, 5, 7), (1, 301, 5, 7),
                                   (3, 33, 1, 1), (2, 9, 12, 70),
                                   (2, 0, 4, 5), (2, 5, 20, 300),
                                   (1, 3, 600, 17)])
def test_k4_decompositions_are_gamma3(shape):
    a = _loads(shape, seed=1)
    route, _, band = sat_ops.sat3_plan(*shape, SMS)
    got = (_k4_by_bands(a, band) if route == "sat3" else _k4_general(a))
    assert torch.equal(got, sat_ref.gamma3_ref(a))


@pytest.mark.parametrize("shape", [(16, 130, 5, 7), (2, 9, 12, 70),
                                   (2, 5, 20, 300), (2, 3, 16, 129),
                                   (1, 6, 257, 3), (3, 40, 64, 100)])
def test_k4_float64_decompositions_are_gamma3(shape):
    """The float64 plan (``itemsize=8``) replayed like the float32 one."""
    a = _loads(shape, seed=2)
    route, _, band = sat_ops.sat3_plan(*shape, SMS, itemsize=8)
    got = (_k4_by_bands(a, band) if route == "sat3" else _k4_general(a))
    assert torch.equal(got, sat_ref.gamma3_ref(a))
