"""Serving (``repro_torch.serve``, ``repro_torch.obs.hist``) against the JAX
package's, on the CPU.

Both packages get the same seeded NumPy inputs (request lengths, arrival
streams) and must agree exactly: histogram buckets, prefix queries, cut
arrays, assignments and every count, latency and replan of a simulated
run.  The one departure is F1: ``LengthPrefix.cut_below(X, strict=True)``
follows ``searchsorted`` where no entry qualifies (index -1 for
``lens=[1]``, ``X=0``); the reference returns 0 there.
"""
import dataclasses

import numpy as np
import pytest

from repro.obs.hist import LogHistogram as JaxHist
from repro.rebalance import policy as jax_policy
from repro.serve import batcher as jax_batcher
from repro.serve import queue as jax_queue
from repro.serve import simulate as jax_sim
from repro_torch import obs
from repro_torch.obs.counters import C
from repro_torch.rebalance import policy
from repro_torch.serve import batcher, simulate
from repro_torch.serve import queue as squeue


# ---------------------------------------------------------------------------
# LogHistogram


def _hist_pair(**kw):
    return obs.LogHistogram(**kw), JaxHist(**kw)


@pytest.mark.parametrize("kw", [{}, dict(lo=1e-3, hi=1e5),
                                dict(lo=0.5, hi=2.0, per_decade=7)])
def test_log_histogram_matches_jax(kw):
    rng = np.random.default_rng(0)
    ours, theirs = _hist_pair(**kw)
    for _ in range(5):
        v = rng.lognormal(0, 3, 1000)
        v[:3] = [0.0, 1e-9, 1e9]                 # underflow and overflow
        ours.add(v)
        theirs.add(v)
    ours.add([])
    np.testing.assert_array_equal(ours.counts, theirs.counts)
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.summary() == theirs.summary()
    o2, t2 = _hist_pair(**kw)
    o2.add([1.0, 2.0])
    t2.add([1.0, 2.0])
    ours.merge(o2)
    theirs.merge(t2)
    assert ours.summary() == theirs.summary()
    assert obs.LogHistogram is obs.hist.LogHistogram


def test_log_histogram_guards():
    h = obs.LogHistogram()
    assert h.percentile(50) == 0.0 and h.mean == 0.0
    for bad in ([-1.0], [np.nan], [np.inf]):
        with pytest.raises(ValueError, match="finite"):
            h.add(bad)
    with pytest.raises(ValueError, match="0 < lo < hi"):
        obs.LogHistogram(lo=2.0, hi=1.0)
    with pytest.raises(ValueError, match="bucketing"):
        h.merge(obs.LogHistogram(per_decade=8))


# ---------------------------------------------------------------------------
# LengthPrefix


def _dense(lengths) -> np.ndarray:
    ls = np.sort(np.asarray(lengths, dtype=np.int64))[::-1]
    return np.concatenate([[0], np.cumsum(ls)])


def _filled(mod, lengths, cap=4096, block=64):
    pf = mod.LengthPrefix(cap=cap, block=block)
    pf.add(lengths)
    return pf


def _length_sets():
    rng = np.random.default_rng(3)
    sets = [[1], [5, 5, 5], [4096, 1, 64, 63, 65], list(range(1, 70))]
    sets += [rng.integers(1, 4097, rng.integers(1, 90)).tolist()
             for _ in range(12)]
    return sets


@pytest.mark.parametrize("lens", _length_sets())
def test_length_prefix_matches_searchsorted_and_jax(lens):
    """Every query at every prefix value, one off each side and past the
    total: ``prefix_tokens``, ``cut_below`` (both sides) and
    ``first_at_least`` equal ``searchsorted`` on the dense array and the
    reference, except F1 (strict, X <= 0)."""
    ours, theirs = _filled(squeue, lens), _filled(jax_queue, lens)
    p = _dense(lens)
    assert ours.max_element() == theirs.max_element() == max(lens)
    for c in range(len(lens) + 2):
        assert ours.prefix_tokens(c) == theirs.prefix_tokens(c) == \
            int(p[min(c, len(lens))])
    xs = sorted({int(v) + d for v in p for d in (-1, 0, 1)} | {-5, 0})
    for x in xs:
        e, pe = ours.cut_below(x)
        want = int(np.searchsorted(p, x, side="right")) - 1
        assert e == want
        if want >= 0:
            assert pe == int(p[e]) and (e, pe) == theirs.cut_below(x)
        es, _ = ours.cut_below(x, strict=True)
        assert es == int(np.searchsorted(p, x, side="left")) - 1
        if x > 0:
            assert ours.cut_below(x, strict=True) == \
                theirs.cut_below(x, strict=True)
        assert ours.first_at_least(x) == theirs.first_at_least(x) == \
            int(np.searchsorted(p, x, side="left"))


def test_cut_below_departs_from_the_reference_at_f1():
    """F1 on both sides: ``lens=[1]``, ``X=0``, strict.  searchsorted
    gives -1; the reference returns 0, the port -1."""
    p = _dense([1])
    want = int(np.searchsorted(p, 0, side="left")) - 1
    assert want == -1
    assert _filled(jax_queue, [1]).cut_below(0, strict=True) == (0, 0)
    assert _filled(squeue, [1]).cut_below(0, strict=True) == (-1, 0)
    # an empty structure follows the same contract
    empty = squeue.LengthPrefix(cap=64, block=8)
    assert empty.cut_below(0, strict=True) == (-1, 0)
    assert empty.cut_below(0) == (0, 0) and empty.cut_below(7) == (0, 0)


def test_length_prefix_updates_match_jax():
    rng = np.random.default_rng(0)
    ours = squeue.LengthPrefix(cap=1024, block=32)
    theirs = jax_queue.LengthPrefix(cap=1024, block=32)
    live = []
    for _ in range(30):
        add = rng.integers(1, 1025, rng.integers(0, 20)).tolist()
        ours.add(add)
        theirs.add(add)
        live += add
        if live and rng.random() < 0.6:
            k = int(rng.integers(1, len(live) + 1))
            rng.shuffle(live)
            gone, live = live[:k], live[k:]
            ours.remove(gone)
            theirs.remove(gone)
        assert (ours.n, ours.total) == (theirs.n, theirs.total)
        for c in (0, len(live) // 3, len(live)):
            assert ours.prefix_tokens(c) == theirs.prefix_tokens(c)
    with pytest.raises(ValueError, match="not present"):
        ours.remove([1024] * (live.count(1024) + 1))
    with pytest.raises(TypeError, match="integers"):
        ours.add([1.5])
    with pytest.raises(ValueError, match=r"\[1, 1024\]"):
        ours.add([0])


@pytest.mark.parametrize("lens", _length_sets()[1:])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_incremental_solvers_match_jax(lens, m):
    """``direct_cut``, ``probe`` and ``optimal_cuts`` (with and without a
    warm bottleneck and speeds) off the incremental structure."""
    ours, theirs = _filled(squeue, lens), _filled(jax_queue, lens)
    sp = np.random.default_rng(m).uniform(0.2, 3.0, m)
    if m > 1:
        sp[0] = 0.0
    for speeds in (None, sp):
        np.testing.assert_array_equal(
            squeue.direct_cut(ours, m, speeds=speeds),
            jax_queue.direct_cut(theirs, m, speeds=speeds))
        for warm in (None, sum(lens) / m, float(max(lens)), 1e9):
            np.testing.assert_array_equal(
                squeue.optimal_cuts(ours, m, warm=warm, speeds=speeds),
                jax_queue.optimal_cuts(theirs, m, warm=warm, speeds=speeds))
    for L in (max(lens) - 1, max(lens), sum(lens) / m + max(lens)):
        a = squeue.probe(ours, m, L)
        b = jax_queue.probe(theirs, m, L)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the request queue and the batcher


def _queues(lengths):
    rng = np.random.default_rng(5)
    at = np.sort(rng.uniform(0, 10, len(lengths)))
    qs = (squeue.RequestQueue(cap=4096, block=64),
          jax_queue.RequestQueue(cap=4096, block=64))
    for q in qs:
        q.admit(lengths, arrival_times=at)
    return qs


def _same_queue(a, b) -> None:
    for c in squeue.RequestQueue._COLS:
        np.testing.assert_array_equal(getattr(a, c), getattr(b, c))


def test_request_queue_matches_jax():
    rng = np.random.default_rng(1)
    lens = rng.integers(1, 4097, 300)
    ours, theirs = _queues(lens)
    _same_queue(ours, theirs)
    for algo in ("optimal", "direct"):
        np.testing.assert_array_equal(ours.plan_cuts(5, algo=algo),
                                      theirs.plan_cuts(5, algo=algo))
    cuts = ours.plan_cuts(5)
    for q in (ours, theirs):
        q.assign_contiguous(cuts)
    more = rng.integers(1, 4097, 40)
    for q in (ours, theirs):
        q.admit(more, arrival_times=11.0)
        q.extend_greedy(5, speeds=[1.0, 0.0, 2.0, 1.0, 0.5])
    _same_queue(ours, theirs)
    np.testing.assert_array_equal(ours.loads(5), theirs.loads(5))
    for now in (11.0, 12.0, 13.0):
        a = ours.serve([3000, 0, 9000, 4000, 100], now=now, dt=1.0)
        b = theirs.serve([3000, 0, 9000, 4000, 100], now=now, dt=1.0)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        _same_queue(ours, theirs)
        ours.check()
    np.testing.assert_array_equal(ours.evict_indices(np.array([0, 3, 7])),
                                  theirs.evict_indices(np.array([0, 3, 7])))
    _same_queue(ours, theirs)
    assert [dataclasses.astuple(r) for r in ours.as_requests()] == \
        [dataclasses.astuple(r) for r in theirs.as_requests()]


def _requests(mod, lens):
    return [mod.Request(i, int(t)) for i, t in enumerate(lens)]


def _groups(assignments) -> list:
    return [(a.replica, [r.rid for r in a.requests]) for a in assignments]


@pytest.mark.parametrize("seed", range(4))
def test_batcher_plan_and_replan_match_jax(seed):
    """``plan`` (optimal, direct, rb; speeds; warm), ``replan`` without a
    policy and graded by each policy, and the helpers, on the same
    requests: the same groups, modes and loads."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 2000, rng.integers(10, 120))
    new = rng.integers(1, 2000, rng.integers(0, 30))
    R = int(rng.integers(2, 9))
    sp = rng.uniform(0.25, 3.0, R)
    sp[-1] = 0.0
    reqs, jreqs = _requests(batcher, lens), _requests(jax_batcher, lens)
    arr = [batcher.Request(1000 + i, int(t)) for i, t in enumerate(new)]
    jarr = [jax_batcher.Request(1000 + i, int(t)) for i, t in enumerate(new)]
    for algo in ("optimal", "direct", "rb"):
        for speeds in (None, sp):
            if algo == "rb" and speeds is not None:
                for mod, rq in ((batcher, reqs), (jax_batcher, jreqs)):
                    with pytest.raises(ValueError, match="capacity-aware"):
                        mod.plan(rq, R, algo=algo, speeds=speeds)
                continue
            a = batcher.plan(reqs, R, algo=algo, speeds=speeds)
            b = jax_batcher.plan(jreqs, R, algo=algo, speeds=speeds)
            assert _groups(a) == _groups(b)
    base = batcher.plan(reqs, R)
    jbase = jax_batcher.plan(jreqs, R)
    pols = [None, policy.NeverRebalance(), policy.AlwaysRebalance(),
            policy.HysteresisPolicy(band=0.0), policy.TwoPhaseHysteresis(
                band=0.0, slow_band=0.01)]
    jpols = [None, jax_policy.NeverRebalance(), jax_policy.AlwaysRebalance(),
             jax_policy.HysteresisPolicy(band=0.0),
             jax_policy.TwoPhaseHysteresis(band=0.0, slow_band=0.01)]
    for pol, jpol in zip(pols, jpols):
        for speeds in (None, sp):
            a, ma = batcher.replan(base, arr, policy=pol, speeds=speeds,
                                   alpha=0.5, replan_overhead=10.0)
            b, mb = jax_batcher.replan(jbase, jarr, policy=jpol,
                                       speeds=speeds, alpha=0.5,
                                       replan_overhead=10.0)
            assert ma == mb and _groups(a) == _groups(b)
    assert batcher.imbalance(base) == jax_batcher.imbalance(jbase)
    np.testing.assert_array_equal(batcher.replica_loads(base),
                                  jax_batcher.replica_loads(jbase))
    for x, y in zip(batcher.load_histogram(base, bins=4),
                    jax_batcher.load_histogram(jbase, bins=4)):
        np.testing.assert_array_equal(x, y)
    prog = rng.uniform(0, 1, R).tolist()
    assert _groups(batcher.straggler_rebalance(base, prog, speeds=sp)) == \
        _groups(jax_batcher.straggler_rebalance(jbase, prog, speeds=sp))


# ---------------------------------------------------------------------------
# the simulator


def _same_sim(a, b) -> None:
    for f in ("admitted", "completed", "evicted", "ticks", "sim_time",
              "replans", "migrated_tokens", "queue_peak"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.hist.counts, b.hist.counts)
    assert a.hist.summary() == b.hist.summary()
    np.testing.assert_array_equal(a.latencies(), b.latencies())
    np.testing.assert_array_equal(a.percentile([50, 99]),
                                  b.percentile([50, 99]))
    assert a.throughput == b.throughput
    if a.tick_records is not None:
        assert [dataclasses.astuple(r) for r in a.tick_records] == \
            [dataclasses.astuple(r) for r in b.tick_records]


_POLICIES = {"none": (None, None),
             "two-phase": (policy.TwoPhaseHysteresis(),
                           jax_policy.TwoPhaseHysteresis()),
             "hysteresis": (policy.HysteresisPolicy(),
                            jax_policy.HysteresisPolicy()),
             "every3": (policy.EveryK(3), jax_policy.EveryK(3))}


@pytest.mark.parametrize("pol", list(_POLICIES))
@pytest.mark.parametrize("kw", [
    dict(n_replicas=4, service_rate=4000.0, tick=0.1),
    dict(n_replicas=3, service_rate=1500.0, tick=0.25, deadline=2.0,
         speeds=[1.0, 0.0, 2.0]),
])
def test_simulate_poisson_matches_jax(pol, kw):
    """Seeded Poisson arrivals (heavy-tailed lengths, chunked): counts,
    replans by grade, migrated tokens, histogram buckets, exact p50/p99
    and every tick record equal the reference's."""
    ours, theirs = _POLICIES[pol]
    a = simulate.simulate(simulate.poisson_arrivals(2000, rate=60.0, seed=1,
                                                    chunk=512),
                          policy=ours, record_ticks=True, **kw)
    b = jax_sim.simulate(jax_sim.poisson_arrivals(2000, rate=60.0, seed=1,
                                                  chunk=512),
                         policy=theirs, record_ticks=True, **kw)
    _same_sim(a, b)
    assert a.completed + a.evicted == a.admitted == 2000
    assert a.summary() == b.summary()


@pytest.mark.parametrize("algo", ["optimal", "direct"])
def test_simulate_trace_matches_jax(algo):
    """A recorded trace with bursts and idle gaps (the idle scheduler
    fast-forwards), every tick replanned with ``algo``."""
    rng = np.random.default_rng(7)
    times = np.sort(np.concatenate([rng.uniform(0, 5, 300),
                                    rng.uniform(20, 21, 400)]))
    toks = rng.integers(1, 3000, times.size)
    kw = dict(n_replicas=5, service_rate=3000.0, tick=0.2, algo=algo,
              record_ticks=True, max_ticks=400)
    a = simulate.simulate(simulate.trace_arrivals(times, toks, chunk=128),
                          **kw)
    b = jax_sim.simulate(jax_sim.trace_arrivals(times, toks, chunk=128),
                         **kw)
    _same_sim(a, b)


def test_arrival_generators_match_jax_and_validate():
    for x, y in zip(simulate.poisson_arrivals(5000, rate=3.0, seed=2,
                                              chunk=999),
                    jax_sim.poisson_arrivals(5000, rate=3.0, seed=2,
                                             chunk=999)):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    with pytest.raises(ValueError, match="rate > 0"):
        next(simulate.poisson_arrivals(5, rate=0.0))
    with pytest.raises(ValueError, match="non-decreasing"):
        next(simulate.trace_arrivals([1.0, 0.5], [3, 4]))
    with pytest.raises(ValueError, match="equal length"):
        next(simulate.trace_arrivals([1.0], [3, 4]))
    with pytest.raises(ValueError, match="all zero"):
        simulate.simulate(iter([]), n_replicas=2, service_rate=0.0)


def test_simulate_counts_and_traces_its_ticks():
    C.reset()
    with obs.tracing() as tr:
        res = simulate.simulate(simulate.poisson_arrivals(400, rate=40.0,
                                                          seed=3),
                                n_replicas=2, service_rate=3000.0, tick=0.1,
                                policy=policy.TwoPhaseHysteresis())
    ticks = [e for e in tr.events() if e["name"] == "serve.tick"]
    assert len(ticks) == res.ticks == C.serve_ticks
    assert C.serve_admitted == res.admitted == 400
    assert C.serve_completed == res.completed
    modes = [e for e in tr.events() if e["name"] == "policy.replan_mode"]
    assert len(modes) == res.ticks - res.replans["idle"]
    obs.validate_chrome_trace(tr.chrome_trace())
