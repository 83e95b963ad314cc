"""K2: greedy feasibility probe (replaces
``repro.kernels.probe.probe_counts_pallas``)."""
