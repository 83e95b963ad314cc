"""Parity of the port's plan pricing and executed migration
(``repro_torch.rebalance.execute`` / ``migrate``) with the JAX package's.

Integer streams, totals below 2**24: receipts and loads agree bit for bit
and ``verify_receipt`` passes at zero tolerance.  Plans cross between the
packages through ``_torch_parity`` so a plan made by one is priced and
migrated by the other.
"""
import functools

import numpy as np
import pytest

from _torch_parity import jax_plans_from_torch, torch_plans_from_jax
from repro.rebalance import execute as jax_execute
from repro.rebalance import migrate as jax_migrate
from repro.rebalance import planner as jax_planner
from repro_torch.core import prefix
from repro_torch.rebalance import execute, migrate, planner, stream

T, N1, N2, P, M = 4, 40, 56, 4, 16
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _frames(name: str) -> np.ndarray:
    return stream.STREAMS[name](T, N1, N2, seed=3)


@functools.lru_cache(maxsize=None)
def _plans(name: str, exact: bool):
    return (planner.plan_host(_frames(name), P=P, m=M, exact=exact,
                              device=CPU),
            jax_planner.plan_host(_frames(name), P=P, m=M, exact=exact))


@pytest.mark.parametrize("name", ["drifting-hotspot", "pic"])
@pytest.mark.parametrize("exact", [False, True])
def test_plan_rect_loads_match_jax_and_host(name, exact):
    ours, theirs = _plans(name, exact)
    for t, (a, b) in enumerate(zip(ours, theirs)):
        w = _frames(name)[t]
        got = execute.plan_rect_loads(a, w, device=CPU)
        want = jax_execute.plan_rect_loads(b, w, interpret=True)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, a.loads(prefix.prefix_sum_2d(w)))
        np.testing.assert_array_equal(execute.plan_rect_loads(a, device=CPU),
                                      jax_execute.plan_rect_loads(b))


@pytest.mark.parametrize("name", ["drifting-hotspot", "particle-advection",
                                  "static"])
@pytest.mark.parametrize("weighted", [True, False])
def test_receipts_match_jax_and_ledger(name, weighted):
    ours, theirs = _plans(name, False)
    fr = _frames(name)
    for t in range(T - 1):
        w = fr[t + 1] if weighted else None
        r = execute.execute_migration(ours[t], ours[t + 1], w, device=CPU)
        execute.verify_receipt(ours[t], ours[t + 1], w, receipt=r)
        want = jax_execute.execute_migration(theirs[t], theirs[t + 1], w,
                                             interpret=True)
        assert r.executed_bytes == want.executed_bytes
        assert r.n_transfers == want.n_transfers
        for f in ("pair_bytes", "rect_loads", "rect_received", "device_of"):
            np.testing.assert_array_equal(getattr(r, f), getattr(want, f))
        assert r.executed_bytes == migrate.migration_volume(
            ours[t], ours[t + 1], w)
        np.testing.assert_array_equal(
            migrate.migration_matrix(ours[t], ours[t + 1], w),
            jax_migrate.migration_matrix(theirs[t], theirs[t + 1], w))
    if name == "static":
        assert r.executed_bytes == 0.0 and r.n_transfers == 0


def test_plans_migrate_across_packages():
    """JAX plans executed by the port and the port's plans executed by the
    JAX package give the same receipts."""
    fr = _frames("drifting-hotspot")
    theirs = jax_planner.plan_host(fr, P=P, m=M)
    ours = torch_plans_from_jax(jax_planner.plan_stream(fr, P=P, m=M),
                                (N1, N2))
    back = jax_plans_from_torch(ours)
    r = execute.execute_migration(ours[0], ours[2], fr[2], device=CPU)
    execute.verify_receipt(ours[0], ours[2], fr[2], receipt=r)
    want = jax_execute.execute_migration(back[0], back[2], fr[2])
    jax_execute.verify_receipt(theirs[0], theirs[2], fr[2], receipt=want)
    assert r.executed_bytes == want.executed_bytes > 0
    np.testing.assert_array_equal(r.rect_received, want.rect_received)


def test_per_processor_churn_matches_jax():
    ours, theirs = _plans("drifting-hotspot", True)
    w = _frames("drifting-hotspot")[1]
    a = migrate.per_processor_churn(ours[0], ours[1], w)
    b = jax_migrate.per_processor_churn(theirs[0], theirs[1], w)
    assert a["volume"] == b["volume"] and a["max_link"] == b["max_link"]
    np.testing.assert_array_equal(a["outflow"], b["outflow"])


def test_execute_refuses_bad_inputs():
    ours, _ = _plans("drifting-hotspot", False)
    with pytest.raises(ValueError, match="weights shape"):
        execute.execute_migration(ours[0], ours[1], np.ones((3, 3)),
                                  device=CPU)
    bad = type(ours[0])(ours[0].row_cuts + N1, ours[0].counts,
                        ours[0].col_cuts, ours[0].shape)
    with pytest.raises(ValueError, match="outside"):
        execute.plan_rect_loads(bad, device=CPU)
    with pytest.raises(AssertionError, match="executed_bytes"):
        r = execute.execute_migration(ours[0], ours[1], device=CPU)
        execute.verify_receipt(ours[0], ours[2], receipt=r)
