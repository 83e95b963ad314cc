"""Launch: meshes (``mesh``), the architecture x shape grid (``cells``),
the train step (``steps``) and the training loop (``train``).

The port of ``repro.launch`` for one card.  The dry run and the HLO cost
models (``dryrun``, ``hlo_cost``, ``hlo_analysis``) and ``steps``'
sharded builders wait for the sharding specs (``dist.sharding``).
"""
