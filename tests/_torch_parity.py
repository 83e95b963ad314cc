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
#: tolerance of ``tests/test_flash.py`` by dtype, compared in float32;
#: float16's (the reference's tests take no float16) is about two float16
#: ulps at the outputs' magnitude
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
#: relative L2 limit by dtype, ``||got - want|| / ||want||``
FLASH_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2.5e-3}
#: head dims of the wide route (d > 256) in the CPU tests: past the
#: compiled widths, d % 8 != 0 (300, and 575, the widest that pads to
#: 576: the realigned route on the card), a multiple of 128, DeepSeek-V2's
#: absorbed MLA width (kv_lora_rank 512 + qk_rope_dim 64); past it, the
#: cluster route's: 640 and 1024 (two blocks a query tile) and 1030 (d %
#: 8 != 0, realigned to 1032 on the card: three blocks at 16 bits)
WIDE_DIMS = [257, 300, 384, 575, 576, 640, 1024, 1030]
#: 64-column chunks of d a block of ``flash_wide_cluster`` owns at most
#: (``hc::NB`` and ``fc::NB`` in flash.cu)
CLUSTER_SHARE = 8


def cluster_shares(d: int, elem_bytes: int) -> list[tuple[int, int]]:
    """``flash_wide_cluster``'s blocks for head dim ``d`` and elements of
    ``elem_bytes``, as the CPU emulation of its sum order models them: the
    64-column chunks ``[c0, c1)`` of d each block owns, by rank.  The
    cluster is the fewest blocks whose shares hold ``CLUSTER_SHARE``
    chunks each, balanced (block r from r * CH // C); at 16 bits 6 and 7
    blocks are taken as 8, whose reduce-scatter slots fit the kernel's
    shared memory.  A model of flash.cu's ``blocks_for``: the card tests
    hold its block count to the library's own rule
    (``ops.cluster_blocks``) at every width and to the cluster size each
    launch reads in the kernel (``ops.cluster_blocks_seen``)."""
    ch = -(-d // 64)
    c = -(-ch // CLUSTER_SHARE)
    if elem_bytes == 2 and c in (6, 7):
        c = 8
    return [(r * ch // c, (r + 1) * ch // c) for r in range(c)]


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


def alternating_case(S, n, K, seed=0):
    """Rows of spikes (load 1000) whose runs of zero loads between them
    alternate between 1-4 entries and 10,000-40,000, so consecutive greedy
    intervals alternate between a few entries and tens of thousands and a
    window predicted from the last interval misses on both sides;
    candidates from one spike (each interval a spike and the zeros after
    it) past two and three, then up to the row total."""
    rng = np.random.default_rng(seed)
    loads = np.zeros((S, n), np.int64)
    for s in range(S):
        i, short = int(rng.integers(0, 8)), True
        while i < n:
            loads[s, i] = 1000
            i += int(rng.integers(1, 5) if short
                     else rng.integers(10_000, 40_000))
            short = not short
    p = np.zeros((S, n + 1), np.int64)
    p[:, 1:] = np.cumsum(loads, axis=1)
    Ls = np.stack([np.r_[1000, 1999, 2000, 3000, 4999,
                         np.linspace(1000, max(int(p[s, -1]), 1000), K)]
                   for s in range(S)])[:, :K].astype(np.int64)
    return p, Ls


def plateau_case(S, n, K, seed=0):
    """Rows of unit loads 129 to 5,000 entries apart, so the prefix is runs
    of equal entries each longer than the general route's window (128);
    candidates 1..K put every target exactly on a run, whose last entry
    ends the interval."""
    rng = np.random.default_rng(seed)
    loads = np.zeros((S, n), np.int64)
    for s in range(S):
        i = int(rng.integers(0, 129))
        while i < n:
            loads[s, i] = 1
            i += int(rng.integers(129, 5001))
    p = np.zeros((S, n + 1), np.int64)
    p[:, 1:] = np.cumsum(loads, axis=1)
    Ls = np.tile(np.arange(1, K + 1), (S, 1)).astype(np.int64)
    return p, Ls


def solver_case(S, n, K, m=1024, seed=0):
    """Rows as the exact 1D solver's (loads in [0, 1000), 16 spikes of
    200,000) and candidates about the bisection's first round at m parts,
    so walks run up to about m steps: one below the largest load (stuck
    at the first spike), then total/m x 0.98 ... 1.4."""
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 1000, (S, n))
    for s in range(S):
        loads[s, rng.choice(n, min(16, n), replace=False)] = 200_000
    p = np.zeros((S, n + 1), np.int64)
    p[:, 1:] = np.cumsum(loads, axis=1)
    Ls = np.stack([np.linspace(0.98, 1.4, K) * p[s, -1] / m
                   for s in range(S)]).astype(np.int64)
    if K > 2 and n > 0:
        Ls[:, 0] = loads.max(axis=1) - 1
    return p, Ls


def big_total_case(S, n, K, seed=0):
    """Rows whose int32 totals are 2**30 - 1, just below the exact path's
    limit (P7): random loads rescaled so the prefix ends there; candidates
    from the largest load up to the total, so targets pass 2**30."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((S, n + 1), np.int64)
    raw[:, 1:] = np.cumsum(rng.integers(0, 20_000, (S, n)), axis=1)
    p = raw * (2 ** 30 - 1) // raw[:, -1:]
    Ls = np.stack([np.linspace(np.diff(p[s]).max(), p[s, -1], K)
                   for s in range(S)]).astype(np.int64)
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
