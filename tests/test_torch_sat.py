"""K1 parity: the port's Gamma / SAT (``repro_torch.kernels.sat``) against
the JAX package's, on the CPU (the kernel against its plain version is in
``test_torch_card.py``).

Loads are integers and every frame total stays below 2**24, so float32
prefix sums are exact and both dtypes must agree bit for bit (tolerance:
none).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, int_loads
from repro.kernels.sat import ops as jax_sat
from repro_torch.kernels import _build
from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.kernels.sat import ref as sat_ref

# odd shapes, none a multiple of the TPU kernel's (256, 512) tiles; 2D
# frames and (B, n1, n2) stacks
SHAPES = [(1, 1), (7, 9), (33, 65), (3, 17, 130), (2, 40, 29)]
DTYPES = {"int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gamma_and_sat_match_jax(shape, dtype):
    a = int_loads(shape, DTYPES[dtype][0])
    before = dict(_build.launches)
    got_g = sat_ops.gamma(torch.from_numpy(a))
    got_s = sat_ops.sat(torch.from_numpy(a))
    for use_pallas in (True, False):
        assert_same(jax_sat.gamma(jnp.asarray(a), use_pallas=use_pallas,
                                  interpret=True), got_g)
        assert_same(jax_sat.sat(jnp.asarray(a), use_pallas=use_pallas,
                                interpret=True), got_s)
    assert got_g.shape == shape[:-2] + (shape[-2] + 1, shape[-1] + 1)
    assert dict(_build.launches) == before  # the CPU never counts a launch


def test_batched_gamma_is_per_frame():
    a = torch.from_numpy(int_loads((4, 11, 13), np.int32, seed=1))
    g = sat_ops.gamma(a)
    for t in range(4):
        assert torch.equal(g[t], sat_ops.gamma(a[t]))


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros(5, dtype=torch.int32), ValueError),
    (torch.zeros((2, 2, 2, 2), dtype=torch.int32), ValueError),
    (torch.zeros((3, 4), dtype=torch.int64), TypeError),
    (torch.zeros((3, 4), dtype=torch.float16), TypeError),
])
def test_gamma_refuses_what_the_kernel_does_not_take(bad, exc):
    with pytest.raises(exc):
        sat_ops.gamma(bad)


def test_gamma3_refuses_float64():
    """Named for the refusal it held until K4 took float64: K1 and K4 both
    take float64 now (the planners' float64 accumulators), and a float64
    Gamma3 of integer loads is the exact int64 prefix; float16 is still
    refused."""
    assert sat_ops.gamma(torch.ones((2, 3), dtype=torch.float64))[-1, -1] \
        == 6
    a = torch.from_numpy(int_loads((2, 3, 4, 5), np.int64))
    g = sat_ops.gamma3(a.double())
    assert g.dtype == torch.float64
    assert torch.equal(g, sat_ref.gamma3_ref(a).double())
    with pytest.raises(TypeError, match="gamma3 takes float32 or int32 or "
                       "float64"):
        sat_ops.gamma3(torch.zeros((2, 3, 4), dtype=torch.float16))
