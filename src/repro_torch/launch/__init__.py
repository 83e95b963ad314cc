"""Launch: meshes (``mesh``), the architecture x shape grid (``cells``),
the steps and their sharded builders (``steps``), the training loop
(``train``) and the dry run (``dryrun``) with its cost model
(``op_cost``, ``roofline``).

The port of ``repro.launch``.  The reference's HLO cost models
(``hlo_cost``, ``hlo_analysis``) read XLA's compiled program; the port
counts its eager program on ``meta`` (``op_cost``) and derives the
roofline's collectives from the specs (``roofline``).
"""
