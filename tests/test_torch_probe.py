"""K2 parity: the port's greedy probe counts (``repro_torch.kernels.probe``)
against the JAX package's (Pallas in interpret mode and its plain
oracle), on the CPU (the kernel against its plain version is in
``test_torch_card.py``).  Counts are integers: tolerance none, in int32
and float32 alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (alternating_case, assert_same, long_run_case,
                           plateau_case, probe_case)
from repro.kernels.probe import ops as jax_probe
from repro_torch.kernels.probe import ops as probe_ops

DTYPES = {"int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32)}


@pytest.mark.parametrize("S,n,K,cap", [
    (1, 0, 3, 2), (3, 1, 4, 1), (5, 17, 7, 4), (4, 130, 9, 16),
    (6, 33, 40, 3), (2, 9, 5, 0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_counts_match_jax(S, n, K, cap, dtype):
    p, Ls = probe_case(S, n, K)
    npd, td = DTYPES[dtype]
    got = probe_ops.probe_counts(torch.from_numpy(p).to(td),
                                 torch.from_numpy(Ls).to(td), cap)
    for use_pallas in (True, False):
        want = jax_probe.probe_counts(jnp.asarray(p.astype(npd)),
                                      jnp.asarray(Ls.astype(npd)), cap,
                                      use_pallas=use_pallas, interpret=True)
        assert_same(want, got)


# the general route's lengths: rows just past the shared-memory limit
# (58,112 and 58,113 loads; the staged route takes up to 58,111) and a
# 4 MB row (1,048,576 loads), with intervals
# of hundreds to thousands of entries; intervals alternating between a
# few entries and tens of thousands, and runs of equal prefixes longer
# than the general route's window.  Pallas in interpret mode where the
# row is below 10**5 entries, the JAX package's oracle everywhere.
@pytest.mark.parametrize("case,S,n,K,cap", [
    ("long", 2, 58112, 4, 24), ("long", 2, 58113, 4, 40),
    ("long", 1, 1048576, 4, 64), ("alternating", 1, 300000, 6, 64),
    ("plateau", 2, 58113, 5, 48)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_counts_match_jax_at_general_lengths(case, S, n, K, cap,
                                                   dtype):
    make = {"long": long_run_case, "alternating": alternating_case,
            "plateau": plateau_case}[case]
    p, Ls = make(S, n, K)
    npd, td = DTYPES[dtype]
    got = probe_ops.probe_counts(torch.from_numpy(p).to(td),
                                 torch.from_numpy(Ls).to(td), cap)
    assert probe_ops.route(n + 1) == "probe_general"
    for use_pallas in (True, False) if n + 1 < 10 ** 5 else (False,):
        want = jax_probe.probe_counts(jnp.asarray(p.astype(npd)),
                                      jnp.asarray(Ls.astype(npd)), cap,
                                      use_pallas=use_pallas, interpret=True)
        assert_same(want, got)


def test_probe_sentinels():
    p, Ls = probe_case(4, 12, 3)
    got = probe_ops.probe_counts(torch.from_numpy(p).int(),
                                 torch.from_numpy(Ls).int(), 5).numpy()
    assert (got[0] == 1).all()          # all-zero row: one interval
    assert (got[1:, 0] == 6).all()      # L = 0: stuck, cap + 1
    assert (got[1:, 1] == 6).all()      # L < largest element: cap + 1
    empty = torch.zeros((2, 1), dtype=torch.int32)
    assert (probe_ops.probe_counts(empty, torch.ones((2, 3), dtype=torch.int32),
                                   4) == 1).all()  # empty row counts 1


@pytest.mark.parametrize("args,exc", [
    ((torch.zeros((2, 5), dtype=torch.int64),
      torch.zeros((2, 3), dtype=torch.int64)), TypeError),
    ((torch.zeros((2, 5), dtype=torch.int32),
      torch.zeros((2, 3), dtype=torch.float32)), TypeError),
    ((torch.zeros((2, 5), dtype=torch.int32),
      torch.zeros((3, 3), dtype=torch.int32)), ValueError),
])
def test_probe_refuses_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        probe_ops.probe_counts(*args, 3)
