"""K1 and K4: summed-area tables / Gamma in 2D and 3D (replace
``repro.kernels.sat.sat_pallas`` and ``sat3_pallas``)."""
