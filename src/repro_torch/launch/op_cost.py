"""Loop-aware operation and byte counts of a step, on the ``meta`` device.

The port's counterpart of ``repro.launch.hlo_cost``.  The reference walks
the optimised HLO of its compiled step; the port has no HLO, so it counts
the eager program that a step dispatches, on ``meta`` stand-ins (nothing
is allocated or computed):

- FLOPs: the matmul-like operations only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, attention), each counted as
  ``torch.utils.flop_counter.FlopCounterMode`` counts it (2 x multiply-
  adds).  This is the reference's rule, which counts ``dot`` only.
- bytes: every operation's tensor inputs plus outputs, a view (an output
  that aliases an input) counting 0.  This is the traffic of the unfused
  eager program, each operation reading and writing device memory; it is
  not held against XLA's count at fusion boundaries, which leaves a
  fusion's internals out.
- only the step's operations: those on ``meta`` tensors, not a constant
  made on the host and cached on the device (``_step_op``).

``count(fn, *args)`` counts one whole call.  ``cell_costs`` counts a
step of the architecture x shape grid loop-aware, as the reference counts
each while-loop body once times its trip count, so that a cell of 32,768
tokens costs seconds and not the hours of its eager loops:

- ``chunked_attention``: one q chunk (its state, its output) times the q
  chunks, and one visited (q chunk, kv chunk) pair times the pairs the
  loop visits (``band`` included).  Every q chunk and every pair has the
  same shapes, so this is exact.  A call whose inputs require grad
  (training) runs whole: its backward operations run later, in autograd's
  engine, where one pair's could not be told from another's.
- the layer stacks: every layer of a stack runs the same operations (a
  layer's window is a number that changes none), so a step's counts are
  affine in each stack's depth.  The step is counted at a base depth of
  one period of the layer pattern (``global_every`` layers, else one) and
  with each stack one period deeper, and the counts are extrapolated to
  the full depth; a slope that does not divide by the period raises.

``tests/test_torch_dryrun.py`` holds ``cell_costs`` equal to ``count`` of
the whole step on every smoke config.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.dist import ctx
from repro_torch.launch import steps
from repro_torch.launch.cells import Shape
from repro_torch.models import layers

__all__ = ["Costs", "count", "cell_costs"]

@dataclasses.dataclass
class Costs:
    """FLOPs and bytes of a step (global: every device's work together),
    collective bytes by kind (none from a count: ``roofline`` derives them
    from the specs), and the argument leaves the step never reads, as
    ``(argument index, key path)``: the reference's ``jax.jit`` prunes
    such an argument from its program (``keep_unused=False``)."""

    flops: int = 0
    bytes: int = 0
    coll: dict = dataclasses.field(default_factory=dict)
    unread: frozenset = frozenset()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _step_op(inputs, out) -> bool:
    """Whether an operation is the step's own: it touches a ``meta``
    tensor and reads no host tensor but a 0-d one (a scalar).  A constant
    the step makes on the host once and caches on its device (rope's
    frequencies) is not the step's work, on the card as here."""
    ins = [t for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    return (any(t.is_meta for t in ins + outs)
            and not any(t.device.type != "meta" and t.ndim for t in ins))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


#: in-place writes that replace their destination's values
_OVERWRITES = {torch.ops.aten.copy_.default, torch.ops.aten.fill_.Scalar,
               torch.ops.aten.zero_.default}


class _Counter(TorchDispatchMode):
    """Adds each dispatched operation's FLOPs and bytes, times ``scale``,
    and notes the storages whose values on entry the operations read (a
    view reads nothing; an overwrite of a whole tensor, not of a view,
    replaces its values unread, and a later read reads the new ones)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.scale = 1
        self.read = set()
        self.replaced = set()

    def unread(self, args) -> frozenset:
        """The leaves of ``args`` whose storage no operation read."""
        return frozenset((i, path) for i, a in enumerate(args)
                         for path, t in _leaves(a)
                         if _storage(t) not in self.read)

    @contextlib.contextmanager
    def repeat(self, k: int):
        """Counts inside the block ``k`` times."""
        prev = self.scale
        self.scale = prev * k
        try:
            yield
        finally:
            self.scale = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # FlopCounterMode's order: an op without a FLOP rule that decomposes
        # is counted by the operations it decomposes into
        if func._overloadpacket not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not _step_op((args, kwargs), out):
            return out
        if func._overloadpacket in flop_registry:
            self.costs.flops += self.scale * flop_registry[
                func._overloadpacket](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.costs.bytes += self.scale * (_nbytes((args, kwargs))
                                              + _nbytes(out))
            # a whole tensor overwritten, not a view into one: a write into
            # a layer's slice of a stacked cache is the reference's
            # dynamic-update-slice, which reads the rest
            dest = args[0] if func in _OVERWRITES else None
            if dest is not None and dest._base is not None:
                dest = None
            self.read.update(
                _storage(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t is not dest
                and _storage(t) not in self.replaced)
            if dest is not None and _storage(dest) not in self.read:
                self.replaced.add(_storage(dest))
        return out


def count(fn, *args) -> Costs:
    """The FLOPs and bytes of one whole call ``fn(*args)`` on ``meta``
    stand-ins (the operations on ``meta`` tensors)."""
    return _count(fn, args, contextlib.nullcontext)


def _count(fn, args, loops) -> Costs:
    """``fn(*args)`` counted, with ``loops(counter)`` entered around it."""
    counter = _Counter()
    with loops(counter), counter:
        fn(*args)
    counter.costs.unread = counter.unread(args)
    return counter.costs


@contextlib.contextmanager
def _folded_attention(counter: _Counter):
    """``layers.chunked_attention`` counted as one q chunk times the q
    chunks and one visited pair times the pairs, for the block's
    duration: the same stages on the same shapes, each run once."""
    whole = layers.chunked_attention

    def folded(q, k, v, q_pos, kv_pos, *, causal, window, softcap, scale,
               q_chunk, kv_chunk, band_window=0):
        if q.requires_grad or k.requires_grad or v.requires_grad:
            return whole(q, k, v, q_pos, kv_pos, causal=causal,
                         window=window, softcap=softcap, scale=scale,
                         q_chunk=q_chunk, kv_chunk=kv_chunk,
                         band_window=band_window)
        B, Sq, H, _ = q.shape
        Hkv, dv = v.shape[2], v.shape[3]
        qb, qpb, kb, vb, kpb = layers.chunk_stacks(q, k, v, q_pos, kv_pos,
                                                   q_chunk, kv_chunk)
        nq, qc, nk, kc = qb.shape[0], qb.shape[2], kb.shape[0], kb.shape[2]
        band = layers.attention_band(band_window, causal, Sq, qc, kc, nk)
        pairs = sum(len(layers.kv_blocks(i, qc, kc, nk, band, band_window))
                    for i in range(nq))
        j = layers.kv_blocks(0, qc, kc, nk, band, band_window)[0]
        with counter.repeat(nq):
            qi, qp = qb[0], qpb[0]
            state = layers.online_start(B, H, qc, dv, q.device)
        with counter.repeat(pairs):
            state = layers.online_step(
                *state, qi, qp, kb[j], vb[j], kpb[j],
                mqa=Hkv == 1 and H > 1, causal=causal, window=window,
                softcap=softcap, scale=scale)
        with counter.repeat(nq):
            out = layers.online_end(*state)
        return torch.cat([out] * nq, dim=1)[:, :Sq].to(v.dtype)

    layers.chunked_attention = folded
    try:
        yield
    finally:
        layers.chunked_attention = whole


def _depth_fields(cfg) -> dict:
    """{config field: the period of its stack's layer pattern}."""
    fields = {"n_layers": cfg.global_every if cfg.global_every > 0 else 1}
    if cfg.family == "encdec":
        fields["encoder_layers"] = 1
    return fields


def cell_costs(arch: str, shape: Shape, overrides: dict | None = None
               ) -> Costs:
    """The global FLOPs and bytes of the step of ``arch`` x ``shape``
    (``shape.kind`` train, prefill or decode, built as ``launch.steps``
    builds it, with ``overrides`` on the config), loop-aware: attention's
    loops folded and the layer stacks extrapolated from two depths (see
    the module's docstring).  ``unread`` is the base run's: a leaf's path
    does not depend on the depth."""
    cfg = configs.get(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    mesh = ctx.abstract_mesh((1, 1), ("data", "model"))
    opt_cfg = steps.opt_config(cfg) if shape.kind == "train" else None
    periods = _depth_fields(cfg)

    build = {"train": functools.partial(steps.build_train, opt_cfg=opt_cfg),
             "prefill": steps.build_prefill,
             "decode": steps.build_decode}[shape.kind]

    def counted(depths: dict) -> Costs:
        fn, args = build(arch, shape, mesh,
                         overrides={**(overrides or {}), **depths})
        return _count(fn, args, _folded_attention)

    base = counted(periods)
    total = Costs(base.flops, base.bytes, dict(base.coll), base.unread)
    for field, p in periods.items():
        full = getattr(cfg, field)
        if full % p:
            raise ValueError(f"{cfg.name}: {field}={full} is not a whole "
                             f"number of periods of {p} layers")
        deeper = counted({**periods, field: 2 * p})
        for attr in ("flops", "bytes"):
            step = getattr(deeper, attr) - getattr(base, attr)
            if step % p:
                raise ValueError(f"{cfg.name}: the {attr} of {p} more "
                                 f"{field} ({step}) do not divide by {p}")
            setattr(total, attr, getattr(total, attr)
                    + step // p * (full - p))
    return total
