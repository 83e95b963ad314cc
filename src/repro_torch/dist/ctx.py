"""Active-mesh context and device meshes.

The port of ``repro.dist.ctx``.  It keeps the reference's
single-controller model: one process drives every device of the mesh, as
``jax.sharding.Mesh`` does there, so a mesh here is a small frozen
:class:`Mesh`, a grid of ``torch.device`` entries with named axes, not a
``torch.distributed`` process group.  The planner's meshes have one axis
(``planner_mesh``); the training loop's has two, ``("data", "model")``
(``launch.mesh``).  The axis vocabulary is the
reference's (:data:`DP_AXES`): ``rebalance.planner`` shards a frame
stream's time axis over the data-parallel axes that :func:`planner_axes`
names.

A mesh may name one device more than once.  That is the port's
counterpart of the forced host devices the reference's tests use
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``): ``["cpu"] * 8``
in the tests, ``[cuda:0] * D`` on one card, so the sharded path runs
where there is one device.

The model half resolves *logical* axis names against the active mesh
(:func:`mesh_context`): ``"dp"`` is the data-parallel axes present
(``("pod", "data")`` on the multi-pod mesh, ``("data",)`` otherwise),
``"model"`` the tensor-parallel axis where the mesh has one, ``None``
unsharded.  :func:`resolve` gives a :class:`PartitionSpec` (the entries
of the reference's ``jax.sharding.PartitionSpec``), divisibility-safe:
an axis whose size does not divide the dimension is dropped.
:func:`constrain` is the models' sharding hint, and
:class:`AbstractMesh` a mesh of axis names and sizes with no devices,
which the dry run plans for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

__all__ = ["DP_AXES", "Mesh", "AbstractMesh", "PartitionSpec", "P",
           "abstract_mesh", "current_mesh", "mesh_context", "mesh_sizes",
           "dp_axes", "axis_entry", "resolve", "constrain", "planner_mesh",
           "planner_axes", "dp_devices"]

DP_AXES = ("pod", "data")

_state = threading.local()


def _grid(devices, depth: int, names: tuple) -> tuple:
    """``devices`` as nested tuples of ``torch.device``, one level for each
    of ``depth`` axes, every level's entries of one length."""
    if isinstance(devices, (str, torch.device)) or not hasattr(
            devices, "__len__"):
        raise ValueError(f"Mesh: devices for the axes {names} are not "
                         f"nested {len(names)} deep: a flat tuple spans one "
                         f"axis, a grid has one level per axis")
    if not len(devices):
        raise ValueError("Mesh needs at least one device")
    if depth == 1:
        if any(isinstance(d, (list, tuple)) for d in devices):
            raise ValueError(f"Mesh: devices nested deeper than the "
                             f"{len(names)} axes {names}")
        return tuple(torch.device(d) for d in devices)
    rows = tuple(_grid(d, depth - 1, names) for d in devices)
    if len({_extent(r) for r in rows}) != 1:
        raise ValueError(f"Mesh: the device grid for {names} is ragged")
    return rows


def _extent(grid) -> tuple:
    return (len(grid),) + (_extent(grid[0]) if isinstance(grid[0], tuple)
                           else ())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: ``devices`` holds one level of nesting per axis of
    ``axis_names`` (a flat tuple for one axis, where ``devices[i]`` holds
    index ``i``; ``devices[i][j]`` holds index (i, j) of two).  ``shape``
    is ``{axis: size}`` in axis order, as a ``jax.sharding.Mesh``'s is.
    A device may appear more than once."""

    devices: tuple
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self):
        names = tuple(self.axis_names)
        if not names:
            raise ValueError("Mesh needs at least one axis")
        object.__setattr__(self, "devices",
                           _grid(self.devices, len(names), names))
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, _extent(self.devices)))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes and their sizes, and no devices: what a step is
    planned for where the devices are not there (the dry run's production
    meshes).  ``shape`` is ``{axis: size}`` in axis order, as a
    :class:`Mesh`'s is."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        sizes, names = tuple(self.axis_sizes), tuple(self.axis_names)
        if not names or len(sizes) != len(names):
            raise ValueError(f"AbstractMesh: {len(sizes)} sizes for the "
                             f"axes {names}")
        if any(int(n) < 1 for n in sizes):
            raise ValueError(f"AbstractMesh: axis sizes {sizes} must be "
                             f"positive")
        object.__setattr__(self, "axis_sizes", tuple(int(n) for n in sizes))
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(shape, axes) -> AbstractMesh:
    """An :class:`AbstractMesh` of ``shape`` over the axis names ``axes``."""
    return AbstractMesh(tuple(shape), tuple(axes))


class PartitionSpec(tuple):
    """A sharding spec: one entry a dimension, each ``None`` (replicated),
    a mesh axis name, or a tuple of axis names (sharded over their
    product).  ``tuple(spec)`` holds the entries, as ``tuple`` of the
    reference's ``jax.sharding.PartitionSpec`` does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def current_mesh():
    """The mesh declared by the innermost :func:`mesh_context`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Declare ``mesh`` (a :class:`Mesh` or an :class:`AbstractMesh`) as
    the active mesh for the duration of the block: :func:`constrain` and
    the models' choice of attention layout read it."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_sizes(mesh) -> dict:
    """{axis name: size}, for :class:`Mesh` and :class:`AbstractMesh`
    alike."""
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


def resolve(mesh, spec, shape=None) -> PartitionSpec:
    """Logical spec entries -> a :class:`PartitionSpec` for ``mesh``.

    ``spec`` entries are None, ``"dp"``, or a mesh axis name (a name the
    mesh lacks resolves to None).  When ``shape`` is given, axes whose
    size product does not divide the corresponding dimension are dropped
    (divisibility safety).
    """
    sizes = mesh_sizes(mesh)
    entries = []
    for d, s in enumerate(spec):
        if s is None:
            entries.append(None)
            continue
        axes = dp_axes(mesh) if s == "dp" else (
            (s,) if s in sizes else ())
        if shape is not None and axes:
            k = math.prod(sizes[a] for a in axes)
            if k == 0 or shape[d] % k != 0:
                axes = ()
        entries.append(axis_entry(axes))
    return PartitionSpec(*entries)


def constrain(x, *spec):
    """The models' sharding hint: returns ``x`` itself.

    The reference pins ``x`` to the resolved sharding of ``spec`` on the
    active mesh (``jax.lax.with_sharding_constraint``), which tells its
    partitioner where the tensor should live and never changes a value.
    In the port a model's tensors sit on one device (a single-controller
    mesh whose entries all name that device, or ``meta`` for an
    :class:`AbstractMesh`), so there is nothing to move.  With a mesh
    active, the spec is still resolved against ``x.shape``, and a spec
    longer than ``x.ndim`` raises ``ValueError``, as the reference's
    constraint fails there.
    """
    mesh = current_mesh()
    if mesh is not None:
        if len(spec) > x.ndim:
            raise ValueError(f"constrain: spec {spec} has {len(spec)} "
                             f"entries for a tensor of {x.ndim} dimensions")
        resolve(mesh, spec, shape=x.shape)
    return x


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


def dp_devices(mesh) -> tuple[torch.device, ...]:
    """The devices a frame stream's shards run on, in order: the grid's
    entries along the DP axes (row-major), at index 0 of every other axis,
    whose entries would hold replicas.  A one-axis planner mesh gives its
    ``devices``."""
    axes = planner_axes(mesh)

    def walk(grid, names):
        if not names:
            return (grid,)
        rows = grid if names[0] in axes else grid[:1]
        return tuple(d for row in rows for d in walk(row, names[1:]))

    return walk(mesh.devices, mesh.axis_names)
