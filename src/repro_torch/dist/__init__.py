"""Distribution: the paper's rectangles, applied to processors.

The port of ``repro.dist``, as far as the planner needs it:

- :mod:`.ctx` — the active-mesh context and the planner's device mesh
  (``planner_mesh``): one process driving a tuple of devices, over which
  ``rebalance.planner`` shards a frame stream by time.
- :mod:`.cp_balance` — context-parallel causal-attention block plans: the
  optimal *contiguous* split is a 1D partitioning problem on the shared
  wide-bisection engine (NumPy).
- :mod:`.moe_placement` — expert placement over the (layer x expert)
  load grid via the registry's jagged partitioners (NumPy).

The model-facing half of ``repro.dist`` (``ctx.resolve``,
``ctx.constrain``, ``ctx.abstract_mesh`` and ``sharding``) serves the
models and is not ported yet.
"""
from __future__ import annotations

from . import cp_balance, ctx, moe_placement

__all__ = ["cp_balance", "ctx", "moe_placement"]
