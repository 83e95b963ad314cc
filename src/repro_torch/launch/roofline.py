"""Roofline terms of a dry-run cell, per device.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
reads its terms from the compiled per-device program; the port has no
compiled program, so:

- FLOPs and bytes per device are the step's global counts
  (``op_cost.cell_costs``) over the mesh's devices: the work divided
  evenly.  A computation the specs leave replicated would add to a
  device's share, which this proxy does not see.
- collective bytes come from the specs (``coll_source: "specs"``), per
  device and by result size, as the reference counts a collective:
  a parameter sharded over the data axes (FSDP) is all-gathered to its
  model shard in each forward, twice in training (the checkpointed layers
  run the forward again), and training reduce-scatters its gradient to
  the shard; a parameter replicated over the data axes all-reduces its
  gradient (training only); a row-parallel product (``wo``, ``w2``,
  ``w_out``) whose contracted dims sit on ``model`` all-reduces its
  ``(B/dp, S, d)`` output in each layer's forward, twice in training.
  Axes of size 1 move nothing.
- memory: argument and output bytes per device, exactly, from the shard
  shapes; temporaries and the peak are ``None``: ``meta`` tensors have
  no allocator.

Hardware constants: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's
data sheet (dense, no sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and
NVLink 4 at 900 GB/s a card, 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.dist import ctx
from repro_torch.dist.sharding import (_ROW_PARALLEL, _STACKED_KEYS,
                                      spec_leaves)

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "Roofline", "shard_bytes",
           "collective_bytes", "memory_summary", "analyze"]

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter")
_NO_ALLOCATOR = ("meta tensors have no allocator: the step's temporaries "
                 "and peak are not measured")


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict[str, int]

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "coll_source": "specs",
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
        }


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _factor(spec, sizes, keep=lambda a: True) -> int:
    """The product of the sizes of ``spec``'s axes that ``keep`` admits."""
    return math.prod(sizes[a] for e in spec for a in _axes(e) if keep(a))


def shard_bytes(leaf, spec, sizes) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``."""
    return leaf.numel() * leaf.element_size() // _factor(spec, sizes)


def _local_batch(mesh, B: int) -> int:
    """A device's rows of a batch of B: B over the data axes where they
    divide it (``dist.sharding.batch_specs``' rule), else B."""
    sizes = ctx.mesh_sizes(mesh)
    n = math.prod(sizes[a] for a in ctx.dp_axes(mesh))
    return B // n if B % n == 0 else B


def _tokens(cfg, shape, keys) -> int:
    """Tokens a layer of the stack at ``keys`` runs in one call."""
    if "enc_layers" in keys:
        return 0 if shape.kind == "decode" else cfg.encoder_len
    return 1 if shape.kind == "decode" else shape.seq_len


def collective_bytes(fn, args, shape) -> dict[str, int]:
    """Per-device bytes of each collective kind, from the step's specs
    (see the module's docstring).  ``fn`` is a ``launch.steps.Step``,
    ``args`` its stand-ins, ``shape`` the cell's ``launch.cells.Shape``."""
    cfg, sizes = fn.cfg, ctx.mesh_sizes(fn.mesh)
    dp = ctx.dp_axes(fn.mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    train = shape.kind == "train"
    forwards = 2 if train else 1
    b_local = _local_batch(fn.mesh, shape.global_batch)
    act = 4 if cfg.dtype == "float32" else 2
    out = dict.fromkeys(_COLLECTIVES, 0)
    for keys, leaf, spec in spec_leaves(args[0], fn.in_specs[0]):
        nbytes = leaf.numel() * leaf.element_size()
        model_shard = nbytes // _factor(spec, sizes, lambda a: a not in dp)
        if _factor(spec, sizes, lambda a: a in dp) > 1:
            out["all-gather"] += forwards * model_shard
            if train:
                out["reduce-scatter"] += shard_bytes(leaf, spec, sizes)
        elif train and n_dp > 1:
            out["all-reduce"] += model_shard
        if keys[-1] not in _ROW_PARALLEL or sizes.get("model", 1) == 1:
            continue
        stacked = any(k in _STACKED_KEYS for k in keys)
        first = 1 if stacked else 0
        contracted = list(range(first, leaf.ndim - 1))
        if "ffn" in keys and "shared" not in keys and cfg.n_experts:
            contracted = contracted[1:]       # the expert axis is not summed
        if any("model" in _axes(spec[d]) for d in contracted
               if d < len(spec)):
            layers = leaf.shape[0] if stacked else 1
            out["all-reduce"] += (forwards * layers * b_local
                                  * _tokens(cfg, shape, keys)
                                  * cfg.d_model * act)
    return out


def _outputs(fn, args, shape):
    """The step's outputs as ([(tree, spec tree)], bytes a device of the
    rest): training returns the parameters and optimizer state as it took
    them, and float32 scalar metrics (the loss's ``nll``, and ``aux`` but
    for the encoder-decoder; ``grad_norm``, ``lr``, ``loss``); serving
    returns the cache as it took it, and float32 logits (B, 1, padded
    vocab), batch-sharded where the data axes divide B."""
    if shape.kind == "train":
        n_metrics = 4 if fn.cfg.family == "encdec" else 5
        return [(args[0], fn.out_specs[0]), (args[1], fn.out_specs[1])], \
            4 * n_metrics
    return [(args[-1], fn.out_specs[1])], (
        4 * _local_batch(fn.mesh, shape.global_batch) * fn.cfg.padded_vocab)


def memory_summary(fn, args, shape, unread=frozenset()) -> dict:
    """Per-device argument and output bytes of the step, from the shard
    shapes; an argument leaf in ``unread`` (``(argument index, key
    path)``, ``op_cost.Costs.unread``) is not an argument, as the
    reference's ``jax.jit`` prunes an argument its program never reads.
    ``temp_bytes`` and ``peak_bytes`` are ``None`` (``note`` says why)."""
    sizes = ctx.mesh_sizes(fn.mesh)
    arg_bytes = sum(shard_bytes(leaf, spec, sizes)
                    for i, (a, specs) in enumerate(zip(args, fn.in_specs))
                    for path, leaf, spec in spec_leaves(a, specs)
                    if (i, path) not in unread)
    trees, extra = _outputs(fn, args, shape)
    out_bytes = extra + sum(shard_bytes(leaf, spec, sizes)
                            for tree, specs in trees
                            for _, leaf, spec in spec_leaves(tree, specs))
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": None, "peak_bytes": None, "note": _NO_ALLOCATOR}


def analyze(costs, fn, args, shape) -> Roofline:
    """The cell's per-device roofline: ``costs`` (global, from
    ``op_cost.cell_costs``) over the mesh's devices, collectives from the
    specs."""
    chips = math.prod(ctx.mesh_sizes(fn.mesh).values())
    coll = collective_bytes(fn, args, shape)
    return Roofline(costs.flops / chips, costs.bytes / chips,
                    float(sum(coll.values())), coll)
