"""Hand-written CUDA kernels of the port, one folder each.

``<name>/<name>.cu`` is the kernel, ``<name>/ref.py`` its plain PyTorch
version and ``<name>/ops.py`` the wrapper: the kernel on a CUDA tensor,
the plain version on a CPU tensor, nothing else.  :mod:`._build` compiles
the sources at first launch and counts launches.
"""
