"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The port keeps the reference package's layout (``obs``, ``core``,
``kernels``, ``rebalance``, ``serve``, ``dist``, ``configs``, ``models``,
``train``, ``data``, ``launch``)
so each module's counterpart sits at the same path under ``src/repro/``.
It imports torch and NumPy only
— never ``jax`` and nothing of ``repro``.  Every Pallas kernel the
ported paths run is a hand-written CUDA kernel under
``kernels/<name>/<name>.cu``, built at first launch (see
``kernels/_build.py``).

Ported so far: the single-device frame planner, frames -> Gamma (K1) ->
JAG-M-HEUR or exact JAG-PQ-OPT (K2) -> host Plans, plus plan pricing
and executed migration (K3); and the single-device 3D planner, volumes
-> Gamma3 (K4) -> SGORP rectilinear cuts (``core.sgorp``); see
``rebalance.planner``; flash attention (K5, ``kernels.flash``) with
the model layer's plain chunked attention (``models.layers``); and the
paper's algorithm registry (``core.registry``: every partitioner by its
paper name) over a NumPy copy of the host engine, its exact device
solvers (``core.device``: 1D, JAG-PQ-OPT, JAG-M-OPT) on the card; the
rebalance runtime, serving and ``dist``; the model stack of every
family (``configs``, ``models.api``: prefill and decode with the
reference's serving semantics, plain PyTorch, as the reference's models
call no kernel); and training on one card (``models.api``'s ``loss``,
``train.optim``, ``train.checkpoint``, ``data.pipeline``,
``launch.train``).
"""
