"""MoE expert placement on the (layer x expert) router-load grid.

Expert parallelism defaults to a uniform grid: every rank hosts
``n_layers / P`` layers x ``n_experts / Q`` experts.  Router counts are
anything but uniform — popularity is Zipf-skewed and drifts across depth
— so the uniform grid's hottest rank dominates step time.  The grid of
per-(layer, expert) token counts is exactly a 2D load matrix, and the
paper's jagged/hierarchical partitioners produce a *rectangular placement
plan*: contiguous layer stripes, each splitting its experts adaptively.
Rectangles keep placement practical — a rank hosts a contiguous slab of
layers/experts, so routing tables stay O(P + sum Q_i), the all-to-all
fan-out per token is bounded, and weights for consecutive layers
co-locate (the rectangles-for-communication argument).

Every bottleneck search inside the partitioners runs on the shared
``core/search.py`` engine via the registry.

The port's NumPy copy of ``repro.dist.moe_placement``: the same code over
the port's copy of the host engine and registry, so its placements are
bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import prefix, registry, search
from repro_torch.core.types import Partition

__all__ = ["PlacementPlan", "plan_expert_placement", "simulate_router_counts"]


def simulate_router_counts(n_layers: int, n_experts: int, *,
                           skew: float = 1.2, tokens_per_layer: int = 65_536,
                           seed: int = 0) -> np.ndarray:
    """Synthetic per-(layer, expert) routed-token counts.

    Expert popularity is Zipf(``skew``) with a slow rotation across depth
    (specialization drifts layer to layer but nearby layers route alike —
    the structure a contiguous-layer-stripe placement exploits), sampled
    as an exact multinomial per layer so rows sum to ``tokens_per_layer``.
    """
    rng = np.random.default_rng(seed)
    base = (1.0 + np.arange(n_experts, dtype=np.float64)) ** -skew
    counts = np.empty((n_layers, n_experts), dtype=np.int64)
    for layer in range(n_layers):
        # drift: popularity ranking rotates ~one expert every other layer
        pop = np.roll(base, layer // 2)
        pop = pop * rng.uniform(0.9, 1.1, n_experts)  # per-layer jitter
        counts[layer] = rng.multinomial(tokens_per_layer, pop / pop.sum())
    return counts


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """An expert placement: rectangle k of ``partition`` means rank k
    hosts experts [c0, c1) of layers [r0, r1)."""

    partition: Partition
    counts: np.ndarray          # the (L, E) load grid the plan was cut for
    ranks: int
    algo: str
    load_imbalance: float       # Lmax / Lavg - 1 of this plan
    uniform_imbalance: float    # same metric for the uniform default grid
    fell_back: bool = False     # algo lost to the uniform grid; plan is it
    speeds: np.ndarray | None = None  # per-rank capacities (None = uniform)


def _uniform_grid(gamma: np.ndarray, ranks: int) -> Partition:
    """The framework-default equal grid: P x Q with P | layers chosen as
    the most-square factor pair (rect-uniform when ``ranks`` is square)."""
    P = int(np.sqrt(ranks))
    while ranks % P:
        P -= 1
    return registry.partition("rect-uniform", gamma, ranks, P=P,
                              Q=ranks // P)


def _imbalance(part: Partition, gamma: np.ndarray, ranks: int,
               sp: np.ndarray | None) -> float:
    """``Lmax / Lavg - 1`` — relative under heterogeneous rank speeds.

    Rectangle order is positional (rank k hosts rectangle k), so rel load
    is ``load_k / sp[k]``; a *loaded* dead rank costs ``inf`` (its tokens
    never finish), an empty one costs 0.  The average is over surviving
    capacity, ``total / sp.sum()``.
    """
    if sp is None:
        return part.load_imbalance(gamma)
    loads = np.asarray(part.loads(gamma), dtype=np.float64)
    total = float(loads.sum())
    if total == 0:
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(loads > 0, loads / sp[:loads.size], 0.0)
    return float(rel.max(initial=0.0)) / (total / float(sp.sum())) - 1.0


def plan_expert_placement(counts: np.ndarray, ranks: int,
                          algo: str = "jag-m-heur-probe", *,
                          speeds=None) -> PlacementPlan:
    """Cut the (L, E) grid into ``ranks`` balanced rectangles.

    ``algo`` is any registry partitioner name; square-only algorithms
    (``rect-*``, ``jag-pq-*``) raise ValueError for non-square ranks,
    which benchmark sweeps treat as "not applicable".

    A plan is never worse than the framework-default uniform grid: if the
    requested algorithm loses on this instance (possible for heuristics
    on adversarial grids), the uniform grid itself is returned with
    ``fell_back=True`` — imbalance <= uniform is an invariant consumers
    may rely on.

    ``speeds`` is a per-rank capacity vector (mixed accelerator
    generations, degraded hosts): the plan minimizes *relative* load
    ``tokens_k / speeds[k]``, dead (``speed=0``) ranks host nothing, and
    both imbalance fields go relative — the uniform grid keeps routing
    tokens to dead ranks, so with any dead rank its relative imbalance is
    ``inf`` and the capacity-aware plan never falls back to it.  ``algo``
    must then be capacity-aware (``registry.CAPACITY_AWARE``).
    """
    counts = np.asarray(counts)
    sp = search.normalize_speeds(speeds, ranks)
    gamma = prefix.prefix_sum_2d(counts)
    part = registry.partition(algo, gamma, ranks, speeds=sp)
    uniform = _uniform_grid(gamma, ranks)
    li = _imbalance(part, gamma, ranks, sp)
    uli = _imbalance(uniform, gamma, ranks, sp)
    fell_back = li > uli
    if fell_back:
        part, li = uniform, uli
    return PlacementPlan(
        partition=part,
        counts=counts,
        ranks=ranks,
        algo=algo,
        load_imbalance=li,
        uniform_imbalance=uli,
        fell_back=fell_back,
        speeds=sp,
    )
