"""K1: summed-area table / Gamma (replaces ``repro.kernels.sat.sat_pallas``)."""
