"""Divisibility-safe ``PartitionSpec`` trees for params / batches / caches.

The port of ``repro.dist.sharding``, rule for rule.  A sharding is a
per-dimension assignment of mesh axes, and a spec is *valid* only if
every assigned axis product divides its dimension.  These builders never
guess-and-pad: each rule proposes a preference order of dimensions for
the tensor-parallel axis, the first divisible one wins, and FSDP picks
the largest remaining divisible dimension, so the same code yields legal
specs for every config in ``repro_torch.configs.ARCHS`` on both
production meshes (2-axis ``(data, model)`` and 3-axis ``(pod, data,
model)``) and degrades to fully replicated on meshes that divide nothing.

Conventions (megatron-style):
- matmul weights shard their *output* features over ``model``; output
  projections (``wo``/``w2``/``w_out``) shard the *reduction* dim instead,
  so the pair forms a column-parallel -> row-parallel block with a single
  all-reduce.
- embedding/head shard the vocab dim (always padded to ``vocab_pad_to``).
- stacked layer leaves keep the leading layer axis unsharded (the
  reference scans over it).
- FSDP shards the largest remaining dimension over the data axes.

The port's trees are nested dicts of tensors (``meta`` stand-ins or real
ones); a leaf's path is its chain of keys.  Only shapes are read.
"""
from __future__ import annotations

import math

from . import ctx
from .ctx import PartitionSpec as P

__all__ = ["param_specs", "batch_specs", "cache_specs", "spec_leaves"]

# parameter collections stacked on a leading layer axis (never sharded)
_STACKED_KEYS = ("layers", "enc_layers", "dec_layers")
# output projections: shard the reduction (input) dim over 'model'
_ROW_PARALLEL = ("wo", "w2", "w_out")
# attention projections (..., heads, head_dim): shard the head axis
_HEAD_PARALLEL = ("wq", "wk", "wv", "wq_b", "wkv_b")
# token-embedding-like tables: shard the (padded) vocab dim
_VOCAB_KEYS = ("embed", "head")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict tree, ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def spec_leaves(tree, specs, path=()):
    """(path, leaf, spec) over a tree and its spec tree, ``path`` the tuple
    of keys; ``ValueError`` where the two trees' keys differ."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(f"{list(path)}: keys {sorted(tree)} do not "
                             f"match the specs' {sorted(specs)}")
        for k in tree:
            yield from spec_leaves(tree[k], specs[k], path + (k,))
    else:
        yield path, tree, specs


def _divides(shape, d: int, axes, sizes) -> bool:
    k = math.prod(sizes[a] for a in axes)
    return k > 0 and shape[d] % k == 0


def _tp_preference(name: str, cand: list[int], shape) -> list[int]:
    """Dimension preference order for the tensor-parallel axis."""
    if not cand:
        return []
    if name in _ROW_PARALLEL:
        # reduction dim first (row-parallel), then from the back
        return [cand[0]] + cand[:0:-1]
    if name in _VOCAB_KEYS:
        big = max(cand, key=lambda d: shape[d])
        return [big] + [d for d in reversed(cand) if d != big]
    if name in _HEAD_PARALLEL and len(cand) >= 2:
        # head axis first (GQA KV head counts below the TP degree fall
        # through to head_dim, then the input dim)
        return [cand[-2], cand[-1]] + cand[-3::-1]
    # column-parallel default: output features live in the trailing dims
    return cand[::-1]


def param_specs(cfg, mesh, pspec, *, fsdp: bool = True):
    """PartitionSpec tree mirroring ``pspec`` (one spec per param leaf).

    ``fsdp=False`` (serving with ``serve_fsdp_params=False``) skips the
    data-axes shard so params replicate across DP: no per-layer
    all-gathers at inference.
    """
    sizes = ctx.mesh_sizes(mesh)
    model_ax = "model" if "model" in sizes else None
    dp = ctx.dp_axes(mesh)

    def spec_for(keys, leaf):
        name = keys[-1] if keys else ""
        stacked = any(k in _STACKED_KEYS for k in keys)
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        cand = list(range(1 if stacked and shape else 0, len(shape)))
        if model_ax:
            for d in _tp_preference(name, cand, shape):
                if _divides(shape, d, (model_ax,), sizes):
                    entries[d] = model_ax
                    break
        if fsdp and dp:
            rem = sorted((d for d in cand if entries[d] is None),
                         key=lambda d: -shape[d])
            for d in rem:
                if _divides(shape, d, dp, sizes):
                    entries[d] = ctx.axis_entry(dp)
                    break
        return P(*entries)

    return _map_with_path(spec_for, pspec)


def batch_specs(cfg, mesh, batch):
    """Batch-dim data parallelism for input trees (tokens/labels/embeds).

    Leaves keep their structure; dim 0 shards over the DP axes when
    divisible (the ``long_500k`` batch-of-1 cell stays replicated).
    """
    sizes = ctx.mesh_sizes(mesh)
    dp = ctx.dp_axes(mesh)

    def spec_for(_, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if dp and shape and _divides(shape, 0, dp, sizes):
            entries[0] = ctx.axis_entry(dp)
        return P(*entries)

    return _map_with_path(spec_for, batch)


def cache_specs(cfg, mesh, cspec):
    """Decode-cache specs: batch over DP, sequence over ``model``.

    Cache leaves are layer-stacked ``(L, B, S, ...)`` (the encoder output
    ``enc`` is the one unstacked ``(B, S, d)`` exception), so the batch
    dim sits at index 1 and the sequence dim right after it.  Sequence
    sharding over ``model`` matches the decode-path ``constrain`` hints
    (the KV cache stays distributed; only the active query replicates).
    Non-divisible dims (SSM conv tails, tiny head counts) fall back to
    replicated per-dim.
    """
    sizes = ctx.mesh_sizes(mesh)
    model_ax = "model" if "model" in sizes else None
    dp = ctx.dp_axes(mesh)

    def spec_for(keys, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        entries = [None] * len(shape)
        bdim = 0 if (keys and keys[0] == "enc") else min(1, len(shape) - 1)
        if dp and _divides(shape, bdim, dp, sizes):
            entries[bdim] = ctx.axis_entry(dp)
        sdim = bdim + 1
        if (model_ax and sdim < len(shape)
                and _divides(shape, sdim, (model_ax,), sizes)):
            entries[sdim] = model_ax
        return P(*entries)

    return _map_with_path(spec_for, cspec)
