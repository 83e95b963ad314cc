"""Shared helpers of the ``test_torch_*`` tests.

The same NumPy input goes through the JAX package (the reference) and its
port in ``repro_torch``; these helpers build those inputs and move results
between the two.  A partitioner has no weights, so the state that crosses
between the packages is the plan: :func:`torch_plans_from_jax` turns the
JAX package's batched plan pytree into the port's ``Plan`` objects and
:func:`jax_plans_from_torch` goes the other way, so a plan made by one
package can be validated, priced and migrated by the other.

This module imports no JAX itself (``jax_plans_from_torch`` does, when
called), so the card-only tests, which run where JAX is not installed,
share its input generators.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.rebalance import batch_device as torch_bd

CPU = torch.device("cpu")


def host(x) -> np.ndarray:
    """A JAX array, a tensor or anything array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(jax_out, torch_out) -> None:
    """Bit-identical results: same values and same dtype, array by array
    (a tuple of arrays or a single array)."""
    if not isinstance(jax_out, (tuple, list)):
        jax_out, torch_out = (jax_out,), (torch_out,)
    assert len(jax_out) == len(torch_out)
    for i, (a, b) in enumerate(zip(jax_out, torch_out)):
        a, b = host(a), host(b)
        assert a.dtype == b.dtype, f"output {i}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")


def torch_plans_from_jax(batched, shape) -> list:
    """The JAX package's batched plan pytree ``(row_cuts, counts,
    col_cuts, Lmax)`` as the port's per-frame ``Plan`` objects."""
    rc, ct, cc = (host(x) for x in batched[:3])
    return [torch_bd.Plan(rc[t], ct[t], cc[t], tuple(shape))
            for t in range(rc.shape[0])]


def jax_plans_from_torch(plans) -> list:
    """The port's ``Plan`` objects as the JAX package's ``Plan`` objects."""
    from repro.rebalance import batch_device as jax_bd
    return [jax_bd.Plan(np.asarray(p.row_cuts), np.asarray(p.counts),
                        np.asarray(p.col_cuts), tuple(p.shape))
            for p in plans]


def assert_same_plans(a, b) -> None:
    """Two lists of plans (from either package) hold the same cuts."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(y.shape)
        for f in ("row_cuts", "counts", "col_cuts"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def ledger_diff(a, b) -> list:
    """Where two ``runtime.RunResult`` ledgers (from either package, or
    the card and the CPU) differ: every ``StepRecord`` field but
    ``wall_time``, exactly (value and type; ``churn``'s arrays by value),
    and the final plan's arrays.  Empty when they agree."""
    import dataclasses
    bad = []
    if len(a.records) != len(b.records):
        return [f"{len(a.records)} records vs {len(b.records)}"]
    for x, y in zip(a.records, b.records):
        for f in dataclasses.fields(x):
            if f.name == "wall_time":
                continue
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, dict) and isinstance(v, dict):
                same = u.keys() == v.keys() and all(
                    np.array_equal(u[k], v[k]) and type(u[k]) is type(v[k])
                    for k in u)
            else:
                same = type(u) is type(v) and u == v
            if not same:
                bad.append(f"step {x.step} {f.name}: {u!r} != {v!r}")
    for f in ("row_cuts", "counts", "col_cuts"):
        if not np.array_equal(getattr(a.final_plan, f),
                              getattr(b.final_plan, f)):
            bad.append(f"final plan {f}")
    return bad


@pytest.fixture
def jax_tracer_kept():
    """Save and restore the JAX package's process-wide tracer around a
    test that drives it (``repro.obs.trace.tracing()`` or
    ``registry.explain``): its events, ``enabled``, ``jax_annotations`` and
    ``epoch_ns``.  ``tracing()`` clears the events on entry and restores
    only the flags on exit, so without this the events a test recorded
    stay behind for whatever test runs next in the same process."""
    from repro.obs import trace as jax_trace
    t = jax_trace.TRACER
    saved = (list(t._events), t.enabled, t.jax_annotations, t.epoch_ns)
    try:
        yield t
    finally:
        t._events, t.enabled, t.jax_annotations, t.epoch_ns = saved


def need_card() -> torch.device:
    """The CUDA device, or skip the calling test: a CUDA kernel has no
    interpret mode, so tests of a kernel against its plain version run on
    the card only (``pytest -m cuda`` there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels run only there")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# inputs, made from a seed with NumPy

#: ``tests/test_flash.py::CASES``, copied here because the machine with the
#: card has no JAX: (B, Sq, Skv, H, d, causal, window, softcap)
FLASH_CASES = [
    (1, 64, 64, 2, 64, True, 0, 0.0),
    (2, 128, 128, 2, 64, True, 0, 0.0),
    (1, 100, 100, 1, 128, True, 0, 0.0),     # ragged vs tile size
    (1, 128, 128, 2, 64, True, 32, 0.0),     # sliding window
    (1, 128, 128, 2, 64, True, 0, 50.0),     # softcap (gemma2)
    (1, 64, 256, 2, 64, False, 0, 0.0),      # cross-attention shape
]
#: tolerance of ``tests/test_flash.py`` by dtype, compared in float32
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def qkv(B, Sq, Skv, H, d, seed=0) -> tuple:
    """Standard normal float32 q (B, Sq, H, d), k and v (B, Skv, H, d)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Skv, H, d)).astype(np.float32),
            rng.standard_normal((B, Skv, H, d)).astype(np.float32))



def int_loads(shape, dtype, seed=0) -> np.ndarray:
    """Integer loads in [0, 100) as ``dtype`` (float32 sums stay exact)."""
    return np.random.default_rng(seed).integers(0, 100, shape).astype(dtype)


def probe_case(S, n, K, seed=0):
    """Prefix rows (S, n+1) and candidates (S, K), int64, with the probe's
    sentinel cases: an all-zero row, L=0 and L below the row's largest
    element, then an ascending sweep up to the row total."""
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 40, (S, n))
    loads[0] = 0
    p = np.zeros((S, n + 1), np.int64)
    p[:, 1:] = np.cumsum(loads, axis=1)
    Ls = np.stack([np.linspace(1, max(int(p[s, -1]), 2), K)
                   for s in range(S)]).astype(np.int64)
    Ls[:, 0] = 0
    if K > 1 and n > 0:
        Ls[:, 1] = np.maximum(loads.max(axis=1) - 1, 0)
    return p, Ls


def long_run_case(S, n, K, seed=0):
    """Rows of mostly zero loads with a few spikes, so greedy intervals
    span hundreds to thousands of entries (more than one window and more
    than 32 windows), and candidates from the largest spike up to the row
    total."""
    rng = np.random.default_rng(seed)
    loads = np.zeros((S, n), np.int64)
    for s in range(S):
        spikes = rng.choice(n, size=rng.integers(1, 9), replace=False)
        loads[s, spikes] = rng.integers(1, 1000, spikes.size)
    loads[0, ::97] = 3                       # one row of even spacing
    p = np.zeros((S, n + 1), np.int64)
    p[:, 1:] = np.cumsum(loads, axis=1)
    hi = p[:, -1]
    Ls = np.stack([np.linspace(loads[s].max(), hi[s], K)
                   for s in range(S)]).astype(np.int64)
    Ls[:, 0] = 0
    return p, Ls


def rectload_case(B, n1, n2, P, Q, seed=0):
    """(Gamma (B, n1+1, n2+1) int64, row cuts (B, P+1), col cuts
    (B, P, Q+1) int32, loads (B, n1, n2)); random cuts may repeat, so
    empty stripes and intervals occur."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 50, (B, n1, n2))
    g = np.zeros((B, n1 + 1, n2 + 1), np.int64)
    g[:, 1:, 1:] = a.cumsum(1).cumsum(2)
    rc = np.stack([np.r_[0, np.sort(rng.integers(0, n1 + 1, P - 1)), n1]
                   for _ in range(B)])
    cc = np.stack([[np.r_[0, np.sort(rng.integers(0, n2 + 1, Q - 1)), n2]
                    for _ in range(P)] for _ in range(B)])
    return g, rc.astype(np.int32), cc.astype(np.int32), a
