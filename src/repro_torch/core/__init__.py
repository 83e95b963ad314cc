"""Core of the port: the Gamma helpers (:mod:`.prefix`), the partition
types (:mod:`.types`, :mod:`.threed`), the 2D device partitioners
(:mod:`.device`) and the d-dimensional SGORP planner (:mod:`.sgorp`)."""
