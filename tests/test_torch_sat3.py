"""K4 parity: the port's Gamma3 / 3D SAT (``repro_torch.kernels.sat``
``gamma3``, ``sat3``) against the JAX package's, on the CPU, through the
reference's plain version and through its Pallas kernel ``sat3_pallas``
in interpret mode (the CUDA kernel against its plain version is in
``test_torch_card.py``).

Tolerance: none on int32 and on integer-valued float32 whose frame totals
stay below 2**24 (every partial sum is then an exact integer, whatever
the order).  Random float32 loads: rtol 1e-5, because the Pallas kernel
sums along axis 3, 2, then 1, while the plain versions sum along axis -3,
-2, then -1, so the float32 sums round at other places (each entry a sum
of at most 34k terms in [0, 1)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, int_loads
from repro.kernels.sat import ops as jax_sat
from repro_torch.kernels import _build
from repro_torch.kernels.sat import ops as sat_ops

# odd shapes, none a multiple of the TPU kernel's (128, 256) tiles; one
# volume and (B, n1, n2, n3) stacks
SHAPES = [(5, 7, 9), (2, 8, 16, 130), (1, 1, 1), (3, 4, 33, 5)]
DTYPES = {"int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gamma3_and_sat3_match_jax(shape, dtype):
    a = int_loads(shape, DTYPES[dtype][0])
    before = dict(_build.launches)
    got_g = sat_ops.gamma3(torch.from_numpy(a))
    got_s = sat_ops.sat3(torch.from_numpy(a))
    for use_pallas in (True, False):
        assert_same(jax_sat.gamma3(jnp.asarray(a), use_pallas=use_pallas,
                                   interpret=True), got_g)
        assert_same(jax_sat.sat3(jnp.asarray(a), use_pallas=use_pallas,
                                 interpret=True), got_s)
    assert got_g.shape == shape[:-3] + tuple(n + 1 for n in shape[-3:])
    assert dict(_build.launches) == before  # the CPU never counts a launch


@pytest.mark.parametrize("shape", SHAPES)
def test_random_float32_gamma3_within_rtol(shape):
    a = np.random.default_rng(3).random(shape).astype(np.float32)
    got = sat_ops.gamma3(torch.from_numpy(a)).numpy()
    for use_pallas in (True, False):
        want = np.asarray(jax_sat.gamma3(jnp.asarray(a),
                                         use_pallas=use_pallas,
                                         interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_float64_gamma3_matches_jax_under_x64(shape):
    """float64 (K4's float64 route on the card) against the reference's
    plain version and Pallas kernel under ``jax.enable_x64()``: integer
    loads up to 2**30 a cell, frame totals far above 2**24 and below
    2**53, so every float64 sum is exact (tolerance: none)."""
    import jax
    a = np.random.default_rng(4).integers(0, 2 ** 30, shape).astype(
        np.float64)
    got = sat_ops.gamma3(torch.from_numpy(a))
    with jax.enable_x64():
        for use_pallas in (True, False):
            assert_same(jax_sat.gamma3(jnp.asarray(a), use_pallas=use_pallas,
                                       interpret=True), got)


def test_batched_gamma3_is_per_frame():
    a = torch.from_numpy(int_loads((3, 6, 5, 7), np.int32, seed=1))
    g = sat_ops.gamma3(a)
    for t in range(3):
        assert torch.equal(g[t], sat_ops.gamma3(a[t]))


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((4, 5), dtype=torch.int32), ValueError),
    (torch.zeros((2, 2, 2, 2, 2), dtype=torch.int32), ValueError),
    (torch.zeros((3, 4, 5), dtype=torch.int64), TypeError),
    (torch.zeros((3, 4, 5), dtype=torch.float16), TypeError),
])
def test_gamma3_refuses_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        sat_ops.gamma3(bad)
