"""Active-mesh context and the planner's device mesh.

The port of the planner half of ``repro.dist.ctx``.  It keeps the
reference's single-controller model: one process drives every device of
the mesh, as ``jax.sharding.Mesh`` does there, so a mesh here is a small
frozen :class:`Mesh` of ``torch.device`` entries with named axes, not a
``torch.distributed`` process group.  The axis vocabulary is the
reference's (:data:`DP_AXES`): ``rebalance.planner`` shards a frame
stream's time axis over the data-parallel axes that :func:`planner_axes`
names.

A mesh may name one device more than once.  That is the port's
counterpart of the forced host devices the reference's tests use
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``): ``["cpu"] * 8``
in the tests, ``[cuda:0] * D`` on one card, so the sharded path runs
where there is one device.

``resolve``, ``constrain`` and ``abstract_mesh`` serve the models and are
not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

__all__ = ["DP_AXES", "Mesh", "current_mesh", "mesh_context", "mesh_sizes",
           "dp_axes", "axis_entry", "planner_mesh", "planner_axes"]

DP_AXES = ("pod", "data")

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: ``devices[i]`` holds index ``i`` of the
    axis ``axis_names[0]``.  ``shape`` is ``{axis: len(devices)}``, as a
    ``jax.sharding.Mesh``'s is."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"Mesh has one axis, got {self.axis_names}")
        if not self.devices:
            raise ValueError("Mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}


def current_mesh():
    """The mesh declared by the innermost :func:`mesh_context`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Declare ``mesh`` as the active mesh for the duration of the block."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_sizes(mesh) -> dict:
    """{axis name: size}."""
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present on ``mesh``, in fixed order."""
    names = mesh.axis_names
    return tuple(a for a in DP_AXES if a in names)


def axis_entry(axes: tuple[str, ...]):
    """Spec entry for a tuple of mesh axes (unwrap singletons)."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def planner_mesh(n_devices: int | None = None, *, devices=None,
                 axis: str = "data") -> Mesh:
    """1-D mesh for frame-sharded stream planning.

    ``devices=None`` takes the CUDA devices (``RuntimeError`` where CUDA
    is absent), the first ``n_devices`` of them when it is given; asking
    for more than there are raises ``ValueError``, as the reference does.
    An explicit ``devices`` list may repeat a device (``["cpu"] * 8``,
    ``[cuda] * 2``): each entry is one index of the mesh axis.
    """
    if devices is None:
        from repro_torch.rebalance.planner import resolve_device
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"planner_mesh: {n_devices} devices requested, "
                             f"{len(devs)} available (pass devices= to name "
                             f"a device more than once)")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), (axis,))


def planner_axes(mesh) -> tuple[str, ...]:
    """The mesh axes a frame stream is sharded over: the DP axes."""
    axes = dp_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {mesh.axis_names} has no data-parallel axis "
                         f"(expected one of {DP_AXES})")
    return axes
