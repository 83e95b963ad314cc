"""repro_torch.serve — the paper's 1D machinery applied to serving (NumPy).

- :mod:`.queue` — the array-backed request queue with its incremental
  prefix structure (``LengthPrefix``) and the 1D solvers over it.
- :mod:`.batcher` — partition-balanced request batching over request
  lists, with policy-graded replans.
- :mod:`.simulate` — the continuous-batching serve simulator.

The port of ``repro.serve``; it runs no kernel and holds nothing on the
card.
"""
