"""K3: jagged rectangle loads (replaces
``repro.kernels.rectload.jagged_loads_pallas``)."""
