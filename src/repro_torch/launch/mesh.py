"""Device meshes for the launchers.

Functions, not module-level constants: importing this module touches no
device.  The axis vocabulary (``DP_AXES``, ``dp_axes``) lives in
``dist.ctx``; this module re-exports ``dp_axes`` for the launchers.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.ctx import Mesh, dp_axes
from repro_torch.rebalance.planner import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "dp_axes"]


def _devices(device) -> list[torch.device]:
    """The CUDA devices for ``device=None`` (``RuntimeError`` without
    CUDA), else ``device`` alone."""
    dev = resolve_device(device)
    if device is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.empty(0, device=dev).device]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh, (16, 16) over ``("data", "model")`` or (2, 16,
    16) over ``("pod", "data", "model")`` with ``multi_pod``: 256 or 512
    devices.  Raises ``ValueError`` where there are fewer, as
    ``jax.make_mesh`` fails there."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _devices(device)
    need = math.prod(shape)
    if len(devs) < need:
        raise ValueError(f"make_production_mesh: the {shape} mesh over "
                         f"{axes} needs {need} devices, {len(devs)} "
                         f"available")
    grid = devs[:need]
    for n in reversed(shape[1:]):
        grid = [tuple(grid[i:i + n]) for i in range(0, len(grid), n)]
    return Mesh(tuple(grid), axes)


def make_local_mesh(device=None) -> Mesh:
    """A (1, 1) mesh of one device with the production axis names
    ``("data", "model")``: the card by default."""
    return Mesh(((_devices(device)[0],),), ("data", "model"))
