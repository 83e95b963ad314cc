"""Distribution: the paper's rectangles, applied to processors.

The port of ``repro.dist``:

- :mod:`.ctx` — the active-mesh context and device meshes of one or
  more named axes, driven by one process: the planner's
  (``planner_mesh``), over which ``rebalance.planner`` shards a frame
  stream by time, and the launchers' ``("data", "model")`` meshes; the
  abstract meshes of the dry run, logical-axis resolution (``resolve``)
  and the models' sharding hint (``constrain``).
- :mod:`.sharding` — divisibility-safe ``PartitionSpec`` trees for
  parameters, batches and decode caches.
- :mod:`.cp_balance` — context-parallel causal-attention block plans: the
  optimal *contiguous* split is a 1D partitioning problem on the shared
  wide-bisection engine (NumPy).
- :mod:`.moe_placement` — expert placement over the (layer x expert)
  load grid via the registry's jagged partitioners (NumPy).
"""
from __future__ import annotations

from . import cp_balance, ctx, moe_placement, sharding

__all__ = ["cp_balance", "ctx", "moe_placement", "sharding"]
