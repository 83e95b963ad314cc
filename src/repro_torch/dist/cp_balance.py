"""Context-parallel causal-attention block balancing (paper 1D machinery).

Sequence parallelism splits a long context into ``n_blocks`` equal token
blocks across ``R`` ranks.  Under causal attention block ``i`` attends to
``i + 1`` KV blocks (windowed: capped at ``window_blocks``), so equal
*counts* are maximally unequal *work* — the last rank does ~2x the
average.  Treating the per-block costs as a 1D load array makes the best
*contiguous* split exactly the paper's chains-on-chains problem, and it
runs on the shared wide-bisection engine (``core.oned.optimal_1d`` ->
``core.search``), not a private halving loop.

Contiguity is the point: contiguous ranges preserve KV locality, so ring
passes stay neighbor-to-neighbor — the paper's rectangles-as-communication
argument in 1D.  The non-contiguous zig-zag (``interleaved_assignment``,
pairing block ``i`` with ``2R-1-i``) reaches exact balance but scatters
each rank's KV across the sequence; it is the upper bound the contiguous
plans are judged against.

The port's NumPy copy of ``repro.dist.cp_balance``: the same code over the
port's copies of the host engine and the policies, so its cuts are
bit-identical.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import jagged, oned, search
from repro_torch.rebalance.policy import HysteresisPolicy, StepState, \
    replan_mode

__all__ = [
    "block_costs", "contiguous_plan", "balanced_plan",
    "balanced_plan_two_phase", "interleaved_assignment", "plan_imbalance",
    "replan_contiguous",
]


def block_costs(n_blocks: int, window_blocks: int = 0) -> np.ndarray:
    """Causal attention cost per block: #KV blocks attended by block i.

    Full causal: ``i + 1``.  Sliding-window attention only looks back
    ``window_blocks`` blocks, so costs saturate there.
    """
    c = np.arange(1, n_blocks + 1, dtype=np.int64)
    if window_blocks > 0:
        np.minimum(c, window_blocks, out=c)
    return c


def _cost_prefix(n_blocks: int, window_blocks: int) -> np.ndarray:
    p = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(block_costs(n_blocks, window_blocks), out=p[1:])
    return p


def contiguous_plan(n_blocks: int, R: int) -> np.ndarray:
    """Naive equal-count contiguous cuts (what sequence sharding defaults
    to): rank r owns blocks [cuts[r], cuts[r+1])."""
    return np.round(np.arange(R + 1) * (n_blocks / R)).astype(np.int64)


def _rel_interval_max(p: np.ndarray, cuts: np.ndarray, speeds) -> float:
    """Max (relative) interval load: ``load_r / speeds[r]``, 0 for empty
    ranks — a loaded dead rank costs ``inf``."""
    if speeds is None:
        return oned.max_interval_load(p, cuts)
    cuts = np.asarray(cuts)
    loads = (p[cuts[1:]] - p[cuts[:-1]]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(loads > 0, loads / speeds[:loads.size], 0.0)
    return float(rel.max(initial=0.0))


def balanced_plan(n_blocks: int, R: int, window_blocks: int = 0,
                  *, speeds=None) -> np.ndarray:
    """Optimal contiguous cuts for the causal cost profile.

    Exact (integer costs) via probe-bisection on the shared engine; the
    plan keeps each rank's KV a single contiguous span.  ``speeds`` is an
    optional per-rank capacity vector (mixed hardware / degraded ranks):
    the split minimizes the *relative* bottleneck ``load_r / speeds[r]``
    and dead (``speed=0``) ranks receive empty spans; ``None`` or
    all-equal speeds keep the homogeneous path bit-identical.
    """
    return oned.optimal_1d(_cost_prefix(n_blocks, window_blocks), R,
                           speeds=speeds)


def balanced_plan_two_phase(n_blocks: int, R: int, window_blocks: int = 0,
                            *, G: int | None = None,
                            speeds=None) -> np.ndarray:
    """HYBRID's two-phase shape in 1D: near-optimal contiguous cuts, fast.

    Phase 1 cuts the blocks into ``G`` contiguous supergroups (one small
    exact solve; ``G`` defaults to the largest divisor of ``R`` at most
    ``round(sqrt(R))``, so a flat cost profile tiles exactly); phase 2
    assigns rank counts and in-group cuts with PROBE-M
    (``oned.nicol_multi`` — every group advances through one packed probe
    set).  The result can be slightly worse than :func:`balanced_plan`
    (the supergroup boundaries constrain it) but costs O(sqrt(R))-deep
    bisections instead of one deep one — the fast candidate
    :func:`replan_contiguous` grades under a phase-aware policy, whose
    bottleneck then *warm-seeds* the exact solve when the policy
    escalates to ``'slow'``.

    With heterogeneous ``speeds`` the supergroups are capacity chunks of
    the rank order (phase 1 cuts blocks proportionally to each chunk's
    speed sum; phase 2's PROBE-M consumes the per-rank speed schedule),
    so slow/dead ranks receive proportionally small/empty spans.
    """
    p = _cost_prefix(n_blocks, window_blocks)
    sp = search.normalize_speeds(speeds, R)
    if G is None:
        G = max((d for d in range(1, int(round(np.sqrt(R))) + 1)
                 if R % d == 0), default=1)
    G = min(G, R)
    if sp is None:
        gcuts = oned.optimal_1d(p, G)
    else:
        G = max(min(G, int((sp > 0).sum())), 1)
        chunk = jagged._speed_chunks(sp, G)
        gsum = np.add.reduceat(sp, chunk[:-1])
        gcuts = oned.optimal_1d(p, G, speeds=gsum)
    subs = [p[gcuts[i]:gcuts[i + 1] + 1] - p[gcuts[i]] for i in range(G)]
    _, _, sub_cuts = oned.nicol_multi(subs, R, speeds=sp)
    cuts = [np.zeros(1, dtype=np.int64)]
    for i, cc in enumerate(sub_cuts):
        cuts.append(np.asarray(cc[1:], dtype=np.int64) + int(gcuts[i]))
    return np.concatenate(cuts)


def interleaved_assignment(n_blocks: int, R: int) -> np.ndarray:
    """Zig-zag block -> rank map: within each band of 2R blocks, rank r
    takes blocks r and 2R-1-r (the ring-attention balancing trick).

    Exactly balanced for full-causal costs when ``2R`` divides
    ``n_blocks``, at the price of non-contiguous KV.
    """
    pos = np.arange(n_blocks, dtype=np.int64) % (2 * R)
    return np.where(pos < R, pos, 2 * R - 1 - pos)


def replan_contiguous(prev_cuts: np.ndarray, n_blocks: int,
                      window_blocks: int = 0, *, policy=None,
                      alpha: float = 0.0, replan_overhead: float = 0.0,
                      last_migration_volume: float = 0.0,
                      steps_since_replan: int = 1,
                      step: int | None = None,
                      two_phase: bool = False,
                      speeds=None) -> tuple[np.ndarray, bool]:
    """Long-context re-split driven by the rebalance hysteresis policy.

    As decoding grows the context from ``prev_cuts[-1]`` to ``n_blocks``
    blocks, the cheap move is *extension* — the last rank absorbs the new
    blocks, no KV migrates.  Computing the candidate fresh split is cheap
    (one warm-started 1D bisection; the extended plan's bottleneck is a
    feasible upper bound by construction) — what costs is *adopting* it,
    which moves KV between ranks.  So the candidate is always computed and
    the same :class:`~repro_torch.rebalance.policy` trigger the 2D runtime
    uses weighs its exact bottleneck gain against the migration bill
    (``alpha`` / ``replan_overhead``).  Returns ``(cuts, replanned)``.
    A static context (``n_blocks == prev_cuts[-1]``) never triggers: the
    extension *is* the previous optimum, so the gain is exactly zero.

    ``two_phase=True`` makes the replan phase-aware (HYBRID's fast/slow
    structure): the graded candidate is the cheap
    :func:`balanced_plan_two_phase` split, and only when the policy — a
    :class:`~repro_torch.rebalance.policy.TwoPhaseHysteresis` exposing
    ``mode()`` — escalates to ``'slow'`` is the exact split solved, its
    bisection *warm-seeded* at the two-phase bottleneck (a sound upper
    bound by construction).  A plain ``decide()`` policy under
    ``two_phase=True`` adopts the fast candidate whenever it triggers.

    ``speeds`` (per-rank capacity; see :func:`balanced_plan`) switches
    every bottleneck in the trigger — the extension's, the candidate's,
    the ideal — to *relative* load, so a rank that just slowed down
    (straggler) inflates the excess and trips the replan even when the
    raw loads did not move.
    """
    prev_cuts = np.asarray(prev_cuts, dtype=np.int64)
    R = len(prev_cuts) - 1
    sp = search.normalize_speeds(speeds, R)
    p_new = _cost_prefix(n_blocks, window_blocks)
    ext = np.minimum(prev_cuts, n_blocks)
    ext[-1] = n_blocks
    max_load = _rel_interval_max(p_new, ext, sp)
    if two_phase:
        cand = balanced_plan_two_phase(n_blocks, R, window_blocks,
                                       speeds=sp)
    else:
        warm = max_load if np.isfinite(max_load) else None
        cand = oned.optimal_1d(p_new, R, warm=warm, speeds=sp)
    cand_load = _rel_interval_max(p_new, cand, sp)
    denom = float(sp.sum()) if sp is not None else float(R)
    state = StepState(step=step if step is not None else steps_since_replan,
                      max_load=max_load,
                      ideal=float(p_new[-1]) / denom,
                      total_load=float(p_new[-1]),
                      achieved_at_replan=cand_load,
                      total_at_replan=float(p_new[-1]),
                      steps_since_replan=steps_since_replan,
                      last_migration_volume=last_migration_volume,
                      alpha=alpha, replan_overhead=replan_overhead)
    policy = policy if policy is not None else HysteresisPolicy()
    # graded through the planner API's shared decision point: a plain
    # decide() policy never escalates — under two_phase it adopts the
    # fast candidate, otherwise cand is already exact
    mode = replan_mode(policy, state)
    if mode == "keep":
        return ext, False
    if mode == "slow" and two_phase:
        cand = oned.optimal_1d(p_new, R, warm=cand_load, speeds=sp)
    return cand, True


def plan_imbalance(plan: np.ndarray, n_blocks: int, R: int,
                   window_blocks: int = 0, contiguous: bool = True,
                   *, speeds=None) -> float:
    """Load imbalance ``Lmax / Lavg - 1`` of a plan (0 == perfect).

    ``plan`` is a cut array (length R+1) for contiguous plans, or a
    block -> rank assignment (length n_blocks) otherwise.  With
    ``speeds`` both sides go relative: per-rank load over speed against
    the surviving-capacity average ``total / speeds.sum()``.
    """
    c = block_costs(n_blocks, window_blocks)
    sp = search.normalize_speeds(speeds, R)
    if contiguous:
        cuts = np.asarray(plan)
        p = _cost_prefix(n_blocks, window_blocks)
        loads = (p[cuts[1:]] - p[cuts[:-1]]).astype(np.float64)
    else:
        loads = np.bincount(np.asarray(plan), weights=c.astype(np.float64),
                            minlength=R)
    if sp is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            loads = np.where(loads > 0, loads / sp[:loads.size], 0.0)
    denom = float(sp.sum()) if sp is not None else float(R)
    avg = float(c.sum()) / denom
    if avg == 0:
        return 0.0
    return float(loads.max(initial=0.0)) / avg - 1.0
