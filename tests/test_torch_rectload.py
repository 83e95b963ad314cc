"""K3 parity: the port's jagged rectangle loads
(``repro_torch.kernels.rectload``) against the JAX package's, on the CPU
(the kernel against its plain version is in ``test_torch_card.py``).
Loads are integers below 2**24: tolerance none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, rectload_case
from repro.kernels.rectload import ops as jax_rl
from repro_torch.kernels.rectload import ops as rl_ops


@pytest.mark.parametrize("B,n1,n2,P,Q", [
    (1, 16, 16, 2, 2), (3, 33, 40, 4, 3), (2, 129, 257, 7, 5),
    (4, 10, 600, 3, 9)])
@pytest.mark.parametrize("gdtype", ["float32", "int32"])
@pytest.mark.parametrize("batched", [True, False])
def test_jagged_loads_match_jax(B, n1, n2, P, Q, gdtype, batched):
    g, rc, cc, a = rectload_case(B, n1, n2, P, Q)
    if not batched:
        g, rc, cc, a = g[0], rc[0], cc[0], a[0]
    g = g.astype(gdtype)
    got = rl_ops.jagged_loads(torch.from_numpy(g), torch.from_numpy(rc),
                              torch.from_numpy(cc))
    for use_pallas in (True, False):
        assert_same(jax_rl.jagged_loads(jnp.asarray(g), jnp.asarray(rc),
                                        jnp.asarray(cc),
                                        use_pallas=use_pallas,
                                        interpret=True), got)
    # a partition's loads sum to the frame total
    np.testing.assert_array_equal(got.numpy().sum(axis=(-2, -1)),
                                  a.sum(axis=(-2, -1)))


def test_jagged_loads_refuse_bad_inputs():
    g = torch.zeros((5, 6), dtype=torch.float64)
    with pytest.raises(TypeError):
        rl_ops.jagged_loads(g, torch.tensor([0, 4]), torch.tensor([[0, 5]]))
    with pytest.raises(ValueError):
        rl_ops.jagged_loads(g.float(), torch.tensor([[0, 4]]),
                            torch.tensor([[0, 5]]))
