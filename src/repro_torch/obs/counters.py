"""Engine counters: one module-level singleton, plain-int increments.

The port's copy of ``repro.obs.counters``, with the same fields.  The
instrumented modules bump attributes on :data:`C` unconditionally — a
Python attribute ``+= 1`` costs tens of nanoseconds — so there is no
enable flag and no function-call indirection on the increment path.  So
far only ``core.sgorp`` bumps counters (``sgorp_iterations``,
``sgorp_projections``, read back from the device loop by its host
entries); the other fields wait for the host engine and the serving
code.  Consumers that want the counts of one region reset or snapshot
:data:`C` around it.
"""
from __future__ import annotations

__all__ = ["Counters", "C"]

_FIELDS = (
    # wide-bisection engine (core.search)
    "bisect_rounds",      # candidate rounds across all bisection drivers
    "probe_calls",        # PackedPrefixes.counts/_counts_speeds/joint_counts
    "probe_chains",       # total (row, candidate-L) chains advanced
    "probe_batch_max",    # widest single packed probe batch (S * K)
    "realize_bumps",      # ulp nudges realize() needed for float bottlenecks
    # scalar 1D probes (core.oned)
    "scalar_probes",      # oned.probe / oned.probe_count invocations
    # stripe memo (core.stripecache.StripeView.cost)
    "stripe_lookups",
    "stripe_hits",
    "stripe_misses",
    # subgrid memo (core.stripecache.SubgridView.cuts_1d[_batch])
    "subgrid_lookups",
    "subgrid_hits",
    "subgrid_misses",
    "subgrid_memo_peak",  # high-water mark of the shared memo's size
    # 3D slab memo (core.threed.SlabCache.solve)
    "slab_lookups",
    "slab_hits",
    "slab_misses",
    # SGORP device refiner (core.sgorp; host wrapper reads the loop's
    # returned iteration/projection counts — jit can't bump Python ints)
    "sgorp_iterations",   # while_loop iterations executed
    "sgorp_projections",  # iterations whose integer projection moved
    # serving (serve.batcher / serve.queue / serve.simulate)
    "serve_plans",
    "serve_replans",
    "serve_queue_peak",   # deepest request queue seen by plan()/replan()
    "serve_ticks",        # simulator scheduler ticks executed
    "serve_admitted",     # requests admitted into the live queue
    "serve_completed",    # requests served to completion
)


class Counters:
    """All engine counters as plain int attributes (see module docstring)."""

    __slots__ = _FIELDS

    FIELDS = _FIELDS

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for f in _FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> dict[str, int]:
        """Copy of every counter as a plain dict (JSON-ready)."""
        return {f: getattr(self, f) for f in _FIELDS}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        nz = {f: v for f, v in self.snapshot().items() if v}
        return f"Counters({nz})"


#: The singleton every instrumented module imports and bumps directly.
C = Counters()
