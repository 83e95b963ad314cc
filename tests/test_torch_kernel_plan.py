"""The probe and rectload kernels' designs (K2, K3), on the CPU.

The kernels run only on the card, and ``test_torch_card.py`` is their check:
it holds them bit for bit against the plain versions at the same edges as
here.  This file keeps a documented model of each design, replayed in NumPy
and torch step by step as the CUDA sources do it: K2's 32-entry window and
the count of its hits, its 32-ary search for long intervals and its
warp-uniform stop; K2's general route, one warp a walk with a 128-entry
window centred on the predicted end, its gallop on a miss and its search
of the bracket; K3's per-column stripe values in warp runs of 32 cut
columns and their differences.  Each replay is held bit for bit against the
plain version (tolerance: none; every case has integer loads, int32 and
float32 alike), which shows that the design computes the plain version's
result; a change of design in a ``.cu`` file must be made here too.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (alternating_case, big_total_case, long_run_case,
                           plateau_case, probe_case, rectload_case,
                           solver_case)
from repro_torch.kernels.probe import compare as probe_compare
from repro_torch.kernels.probe import ops as probe_ops
from repro_torch.kernels.probe import ref as probe_ref
from repro_torch.kernels.rectload import ref as rl_ref
from repro_torch.rebalance.batch_device import Plan

WINDOW = 32  # probe.cu: kWindow
WALKS = 8  # probe.cu: kWalks, the candidates a warp walks at once
GEN_WINDOW = 128  # probe.cu: kGenWindow, 32 lanes x kGenPerLane entries
LANES = 32
RUN = 32  # rectload.cu: kRun, the cut columns of a warp's run
DTYPES = {"int32": (np.int32, torch.int32),
          "float32": (np.float32, torch.float32)}


# ---------------------------------------------------------------------------
# K2: the walk, replayed

def window_scan_counts(p: np.ndarray, Ls: np.ndarray,
                       cap: int) -> np.ndarray:
    """probe.cu's walk in NumPy, all candidates at once.  A step tests the
    32 entries after pos (those up to n) against t = p[pos] + L and counts
    the hits (on the card, 4 lanes each count theirs and shuffles add them
    up); a full window goes on with 32-ary search rounds over (pos + 32,
    n].  The candidates of a warp (``WALKS`` of them) step
    together, and the warp stops when none of them can move.  The entries
    <= t must be a prefix of every window and every search round (the row
    is non-decreasing), which is what lets a count stand for
    upper_bound."""
    S, K = Ls.shape
    n = p.shape[1] - 1
    cpw = WALKS
    lanes = np.arange(1, WINDOW + 1)
    rows = np.arange(S)[:, None]

    def at(idx):
        return p[rows[..., None], np.clip(idx, 0, max(n, 0))]

    def prefix_count(ok):
        c = ok.sum(-1)
        assert (ok == (lanes <= c[..., None])).all(), "not a prefix"
        return c

    pos = np.zeros((S, K), np.int64)
    cnt = np.zeros((S, K), np.int64)
    on = np.full((S, K), n > 0)
    t = (p[:, :1] + Ls) if n >= 0 else Ls.copy()
    warps = -(-K // cpw)
    for _ in range(cap):
        pad = np.zeros((S, warps * cpw), bool)
        pad[:, :K] = on
        if not pad.reshape(S, warps, cpw).any(-1).any():
            break
        idx = pos[..., None] + lanes
        c = prefix_count(on[..., None] & (idx <= n)
                         & (at(idx) <= t[..., None]))
        far = on & (c == WINDOW)
        lo = pos + WINDOW
        top = np.full((S, K), n + 1)
        far &= top - lo > 1
        while far.any():
            stride = np.maximum((top - lo - 1 + WINDOW - 1) // WINDOW, 1)
            j = lo[..., None] + lanes * stride[..., None]
            c2 = prefix_count(far[..., None] & (j < top[..., None])
                              & (at(j) <= t[..., None]))
            top = np.where(far & (c2 < WINDOW),
                           np.minimum(top, lo + (c2 + 1) * stride), top)
            lo = np.where(far, lo + c2 * stride, lo)
            far &= top - lo > 1
        c = np.where(on & (c == WINDOW), lo - pos, c)
        adv = on & (c > 0)
        pos = np.where(adv, pos + c, pos)
        cnt += adv
        on = adv & (pos < n)
        t = np.where(on, p[rows, np.clip(pos, 0, max(n, 0))] + Ls, t)
    return np.where(pos < n, cap + 1, np.maximum(cnt, 1)).astype(np.int32)


def _check_walk(p, Ls, cap, dtype):
    npd, td = DTYPES[dtype]
    p, Ls = p.astype(npd), Ls.astype(npd)
    want = probe_ref.probe_counts_ref(torch.from_numpy(p),
                                      torch.from_numpy(Ls), cap).numpy()
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(window_scan_counts(p, Ls, cap), want)
    return want


@pytest.mark.parametrize("S,n,K,cap", [
    (1, 0, 3, 2), (3, 1, 4, 1), (5, 17, 7, 4), (4, 130, 9, 16),
    (6, 33, 40, 3), (2, 9, 5, 0), (64, 512, 8, 32), (3, 300, 5, 20)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_scan_matches_plain_on_probe_cases(S, n, K, cap, dtype):
    _check_walk(*probe_case(S, n, K), cap, dtype)


@pytest.mark.parametrize("S,n,K,cap", [(6, 100, 5, 8), (8, 3000, 6, 12),
                                       (4, 20000, 4, 40)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_scan_matches_plain_past_one_window(S, n, K, cap, dtype):
    want = _check_walk(*long_run_case(S, n, K), cap, dtype)
    assert (want <= cap).any() and (want == cap + 1).any()


def test_window_scan_intervals_span_more_than_1024_entries():
    """A row of 4,000 zero loads between two spikes: the greedy's first
    interval is 2,000 entries long, so the walk searches past 32 windows."""
    loads = np.zeros((1, 4000), np.int64)
    loads[0, [1999, 3999]] = 5
    p = np.zeros((1, 4001), np.int64)
    p[0, 1:] = np.cumsum(loads)
    Ls = np.array([[5, 9, 10]])
    got = _check_walk(p, Ls, 4, "int32")
    np.testing.assert_array_equal(got, [[2, 2, 1]])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_scan_sentinels(dtype):
    """L = 0 and L below the largest element are stuck (cap + 1), an empty
    row and an all-zero row count 1, cap = 0 gives 1 on every row."""
    p, Ls = probe_case(5, 40, 4)
    got = _check_walk(p, Ls, 6, dtype)
    assert (got[0] == 1).all() and (got[1:, :2] == 7).all()
    empty = np.zeros((3, 1), np.int64)
    assert (_check_walk(empty, np.ones((3, 2), np.int64), 5, dtype)
            == 1).all()
    assert (_check_walk(p, Ls, 0, dtype) == 1).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_window_scan_float32_above_2_24(seed):
    """float32 rows whose prefixes pass 2**24 (loads up to 2**20 each):
    the target rounds, and the walk compares the same float32 values as
    searchsorted does."""
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 2 ** 20, (16, 512)).astype(np.float32)
    p = np.zeros((16, 513), np.float32)
    p[:, 1:] = np.cumsum(loads, axis=1, dtype=np.float32)
    assert p[:, -1].min() > 2 ** 24 and (np.diff(p, axis=1) >= 0).all()
    Ls = np.stack([np.linspace(p[s, -1] / 40, p[s, -1] / 20, 8)
                   for s in range(16)]).astype(np.float32)
    _check_walk(p, Ls, 32, "float32")


@pytest.mark.parametrize("n_plus_1,key", [
    (1, "probe"), (513, "probe"), (58112, "probe"),
    (58113, "probe_general"), (1048577, "probe_general")])
def test_probe_route_by_row_length(n_plus_1, key):
    """K2 stages a row in shared memory while its 4-byte entries fit a
    block's 232,448 bytes (58,112 entries); longer rows take the general
    route, which reads them from global memory with the same walk."""
    assert probe_ops.route(n_plus_1) == key


def test_probe_rows_past_shared_memory_have_a_plain_version():
    """A row of 58,113 entries (the general route's shape) is taken,
    not refused: on the CPU the wrapper answers with the plain version,
    and the walk's replay agrees with it."""
    p, Ls = long_run_case(2, 58112, 3)
    got = probe_ops.probe_counts(torch.from_numpy(p.astype(np.int32)),
                                 torch.from_numpy(Ls.astype(np.int32)), 20)
    np.testing.assert_array_equal(got.numpy(),
                                  window_scan_counts(p, Ls, 20))


# ---------------------------------------------------------------------------
# K2's general route: one warp a walk, replayed

def _round(row, b, d, top, t, st):
    """One round of a walk's warp (probe.cu: read_slots, count_slots):
    slot q reads row[b + q d] where that is below top.  The entries <= t
    must be the first slots; returns their count and the last of them."""
    st["rounds"] += 1
    idx = b + np.arange(GEN_WINDOW, dtype=np.int64) * d
    ok = idx < top
    hit = np.zeros(GEN_WINDOW, bool)
    hit[ok] = row[idx[ok]] <= t
    c = int(hit.sum())
    assert (hit == (np.arange(GEN_WINDOW) < c)).all(), "not a prefix"
    return c, (row[idx[c - 1]] if c else None)


def _prefix(flags):
    c = int(flags.sum())
    assert (flags == (np.arange(LANES) < c)).all(), "not a prefix"
    return c


def general_next(row, pos, n, t, base, st):
    """probe.cu: next_pos.  The last index in (pos, n] whose entry is <= t
    (pos if none) and its entry, from the window of 128 entries at base:
    inside it, by the window's count; before it, by a gallop back from
    base (lane i reads base - 128 * 2**i) down to pos; past it, by a
    gallop on from its end; then 128-ary rounds over the bracket."""
    c, v = _round(row, base, 1, n + 1, t, st)
    shifts = GEN_WINDOW << np.arange(LANES, dtype=np.int64)
    if c == 0:
        if base == pos + 1:
            return pos, None                       # stuck
        st["short"] += 1
        st["rounds"] += 1
        lo, top = pos, base
        j = base - shifts
        inside = j > pos
        above = np.zeros(LANES, bool)
        above[inside] = ~(row[j[inside]] <= t)
        m = _prefix(above)
        if m:
            top = int(j[m - 1])
        if m < LANES and inside[m]:
            lo, v = int(j[m]), row[j[m]]
    elif c == GEN_WINDOW and base + GEN_WINDOW - 1 < n:
        st["long"] += 1
        st["rounds"] += 1
        lo, top = base + GEN_WINDOW - 1, n + 1
        j = lo + shifts
        inside = j < top
        hit = np.zeros(LANES, bool)
        hit[inside] = row[j[inside]] <= t
        h = _prefix(hit)
        if h < LANES:
            top = min(top, int(j[h]))
        if h:
            lo, v = int(j[h - 1]), row[j[h - 1]]
    else:
        return base + c - 1, v                     # the window holds it
    while top - lo > 1:
        d = (top - lo - 2) // GEN_WINDOW + 1
        c2, z = _round(row, lo + d, d, top, t, st)
        if c2 < GEN_WINDOW:
            top = min(top, lo + (c2 + 1) * d)
        if c2:
            lo, v = lo + c2 * d, z
    return lo, v


def general_walk(row, L, cap, st):
    """probe.cu: probe_general_kernel for one walk: the first window right
    after pos, then each centred on pos + the last interval's length."""
    n = len(row) - 1
    pos = cnt = last = 0
    base = 1
    t = row[0] + L if n > 0 else 0
    for _ in range(cap):
        if pos >= n:
            break
        st["steps"] += 1
        nxt, v = general_next(row, pos, n, t, base, st)
        if nxt == pos:
            break
        last, pos, cnt = nxt - pos, nxt, cnt + 1
        t = v + L
        base = max(pos + 1, min(pos + last - GEN_WINDOW // 2,
                                n + 1 - GEN_WINDOW))
    return cap + 1 if pos < n else max(cnt, 1)


def general_counts(p, Ls, cap):
    """Every walk of (S, K) replayed; returns the counts and, per walk, its
    steps, rounds of reads and misses on either side."""
    S, K = Ls.shape
    out = np.zeros((S, K), np.int32)
    stats = []
    with np.errstate(over="ignore"):
        for s in range(S):
            for k in range(K):
                st = dict(steps=0, rounds=0, short=0, long=0)
                out[s, k] = general_walk(p[s], Ls[s, k], cap, st)
                stats.append(st)
    return out, stats


def _check_general(p, Ls, cap, dtype):
    npd, _ = DTYPES[dtype]
    p, Ls = p.astype(npd), Ls.astype(npd)
    want = probe_ref.probe_counts_ref(torch.from_numpy(p),
                                      torch.from_numpy(Ls), cap).numpy()
    got, stats = general_counts(p, Ls, cap)
    np.testing.assert_array_equal(got, want)
    return want, stats


@pytest.mark.parametrize("S,n,K,cap", [
    (1, 0, 3, 2), (3, 1, 4, 1), (5, 17, 7, 4), (4, 130, 9, 16),
    (6, 33, 40, 3), (2, 9, 5, 0), (16, 512, 8, 32), (3, 300, 5, 20)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_general_walk_matches_plain_on_probe_cases(S, n, K, cap, dtype):
    _check_general(*probe_case(S, n, K), cap, dtype)


@pytest.mark.parametrize("case,S,n,K,cap", [
    ("long", 4, 20000, 4, 40), ("long", 2, 58112, 6, 24),
    ("alternating", 2, 300000, 8, 64), ("plateau", 3, 200000, 6, 200),
    ("solver", 2, 100000, 7, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_general_walk_matches_plain_at_its_edges(case, S, n, K, cap, dtype):
    make = {"long": long_run_case, "alternating": alternating_case,
            "plateau": plateau_case,
            "solver": lambda S, n, K: solver_case(S, n, K, m=128)}[case]
    _check_general(*make(S, n, K), cap, dtype)


def test_general_walk_misses_on_both_sides():
    """Intervals alternating between a few entries and tens of thousands:
    a window centred on the last interval's end misses short and long,
    and the gallops still find the plain version's ends."""
    _, stats = _check_general(*alternating_case(2, 300000, 8), 64, "int32")
    assert sum(st["short"] for st in stats) > 10
    assert sum(st["long"] for st in stats) > 10


def test_general_walk_int32_totals_below_2_30():
    p, Ls = big_total_case(2, 100000, 6)
    assert p[:, -1].max() == 2 ** 30 - 1
    _check_general(p, Ls, 40, "int32")


def test_general_walk_takes_one_round_a_step_on_the_solver_row():
    """The 1D solver's first round at (1, 1048577) x 15, cap 1024 (the
    row and candidates ``kernels.probe.compare`` times): the window
    centred on pos + the last interval's length holds the end at most
    steps, so the longest walk reads at most 1.2 rounds a step (the
    staged route's design read about six, one after the other)."""
    row = probe_compare.solver_row()
    cand = probe_compare.first_round(row).numpy()
    want, stats = _check_general(row[None], cand, 1024, "int32")
    longest = max(stats, key=lambda st: st["steps"])
    assert longest["steps"] == 1001
    assert longest["rounds"] <= 1.2 * longest["steps"]
    assert sum(st["rounds"] for st in stats) <= 1.2 * sum(
        st["steps"] for st in stats)


# ---------------------------------------------------------------------------
# K3: the per-column replay

def runs(Qp1):
    """Warps along one stripe's ``Qp1`` cuts (rectload.cu: ``runs``): a warp
    reads ``RUN`` consecutive cuts, and neighbouring runs share one, so it
    writes one interval fewer."""
    return (Qp1 - 2) // (RUN - 1) + 1


@pytest.mark.parametrize("Qp1", [2, 3, 31, 32, 33, 63, 64, 65, 255, 256,
                                 257, 994, 3000])
def test_rectload_runs_cover_every_interval(Qp1):
    got = []
    for r in range(runs(Qp1)):
        q0 = r * (RUN - 1)
        got += [q0 + i for i in range(RUN - 1) if q0 + i < Qp1 - 1]
    assert got == list(range(Qp1 - 1))


def test_rectload_one_plan_fills_the_card():
    """One plan of 32 stripes x 994 cuts: 33 warp runs a stripe, 9 blocks
    of 4 warps, 288 blocks in all, more than the H100's 132 SMs."""
    assert runs(994) == 33
    assert 32 * -(-runs(994) // 4) == 288 >= 132


def column_run_loads(g, rc, cc):
    """rectload.cu in torch: for each frame, stripe and warp's run of
    ``RUN`` cut columns, the stripe values of the run's columns in Gamma's
    dtype, then each column's difference with its right neighbour in the
    run (a shuffle on the card), cast last."""
    B, P, Qp1 = cc.shape
    out = torch.empty((B, P, Qp1 - 1), dtype=torch.float32)
    b = torch.arange(B)[:, None, None]
    r0, r1 = rc[:, :-1, None].long(), rc[:, 1:, None].long()
    for r in range(runs(Qp1)):
        q0 = r * (RUN - 1)
        cols = cc[:, :, q0:q0 + RUN].long()
        sv = g[b, r1, cols] - g[b, r0, cols]
        out[:, :, q0:q0 + cols.shape[2] - 1] = (sv[..., 1:]
                                                - sv[..., :-1]).float()
    return out


def _check_rectload(g, rc, cc):
    want = rl_ref.jagged_loads_ref(g, rc, cc).float()
    assert torch.equal(column_run_loads(g, rc, cc), want)


@pytest.mark.parametrize("B,n1,n2,P,Q", [
    (1, 16, 16, 2, 2), (3, 33, 40, 4, 3), (2, 40, 600, 5, 30),
    (2, 40, 600, 3, 31), (2, 40, 600, 3, 62), (1, 20, 2000, 2, 255),
    (1, 20, 2000, 2, 1023), (2, 9, 300, 1, 300)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_column_runs_match_plain_with_repeated_cuts(B, n1, n2, P, Q, dtype):
    g, rc, cc, _ = rectload_case(B, n1, n2, P, Q)
    _check_rectload(torch.from_numpy(g).to(DTYPES[dtype][1]),
                    torch.from_numpy(rc), torch.from_numpy(cc))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_column_runs_match_plain_on_padded_plans(dtype):
    """Plans as pricing hands them over: P = 32 stripes, m = 1024, so
    993 intervals a stripe with the dead ones pinned at n2
    (``Plan._live_col_cuts``)."""
    rng = np.random.default_rng(2)
    n1 = n2 = 512
    P, m = 32, 1024
    a = rng.integers(0, 50, (4, n1, n2))
    g = np.zeros((4, n1 + 1, n2 + 1), np.int64)
    g[:, 1:, 1:] = a.cumsum(1).cumsum(2)
    rcs, ccs = [], []
    for _ in range(4):
        counts = 1 + rng.multinomial(m - P, np.ones(P) / P)
        cuts = np.full((P, m - P + 2), -7)   # masked entries: garbage
        for s, k in enumerate(counts):
            cuts[s, :k + 1] = np.r_[0, np.sort(rng.integers(0, n2 + 1, k - 1)),
                                    n2]
        rows = np.r_[0, np.sort(rng.integers(0, n1 + 1, P - 1)), n1]
        plan = Plan(rows, counts, cuts, (n1, n2))
        rcs.append(plan.row_cuts)
        ccs.append(plan._live_col_cuts())
    cc = torch.from_numpy(np.stack(ccs).astype(np.int32))
    assert cc.shape == (4, P, 994)
    _check_rectload(torch.from_numpy(g).to(DTYPES[dtype][1]),
                    torch.from_numpy(np.stack(rcs).astype(np.int32)), cc)


def test_column_runs_wrap_int32_past_2_31():
    """int32 Gamma entries past 2**31 wrap; the stripe values and their
    differences wrap the same way in both."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 20, (2, 64, 300))
    g = np.zeros((2, 65, 301), np.int64)
    g[:, 1:, 1:] = a.cumsum(1).cumsum(2)
    assert g.max() > 2 ** 31
    g32 = torch.from_numpy(((g + 2 ** 31) % 2 ** 32 - 2 ** 31)
                           .astype(np.int32))
    _, rc, cc, _ = rectload_case(2, 64, 300, 3, 200, seed=3)
    _check_rectload(g32, torch.from_numpy(rc), torch.from_numpy(cc))
