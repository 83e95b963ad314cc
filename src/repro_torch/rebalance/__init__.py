"""repro_torch.rebalance — the frame planner and its consumers on the card.

- :mod:`.planner` — ingest -> SAT -> partition -> collect on one device,
  with lazy per-slice iteration and per-stage profiling.
- :mod:`.batch_device` — standalone batched entry points and the host
  ``Plan`` view.
- :mod:`.stream` — time-evolving workload generators (NumPy).
- :mod:`.migrate` — plan diffing: migration volume / flow / churn (NumPy).
- :mod:`.execute` — executed migrations and per-rectangle pricing on the
  card (kernel K3).
- :mod:`.policy` — never / always / every-K / hysteresis replan triggers
  (no torch; also used by the serving code).
- :mod:`.faults` — capacity events and the capacity-aware host planner
  (NumPy).
- :mod:`.runtime` — the stepped cost loop and policy comparison harness
  over the planner on the card.
"""
