"""Step functions (train / prefill / decode) with their sharding specs.

The port of ``repro.launch.steps``.  ``make_train_step`` is the model's
loss, its gradients by autograd and one AdamW step.  Each builder returns
``(fn, arg_specs)``: ``arg_specs`` are stand-ins of the step's inputs on
the ``meta`` device (nothing is allocated), and ``fn`` a :class:`Step`
that carries the inputs' and outputs' ``PartitionSpec`` trees
(``dist.sharding``) and runs the step under ``mesh_context(mesh)``.

Where ``fn`` runs follows the mesh, as the reference's jitted step runs
on its mesh: an ``AbstractMesh`` on ``meta`` (shapes, and the dry run's
counts, without a device); a ``Mesh`` whose entries all name one device
(the card's ``make_local_mesh()``, or ``[cuda] * 4`` as a (2, 2) grid) on
that device, where the specs are hints that change no value
(``dist.ctx.constrain``).  Computing a model across several distinct
devices is not ported (``NotImplementedError``).

The reference donates the parameters and optimizer state (train) and the
cache (prefill, decode) to its step.  Here ``optim.apply`` returns new
tensors and the cache is written in place, so there is nothing to donate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import configs
from repro_torch.dist import ctx
from repro_torch.dist import sharding as shd
from repro_torch.launch.cells import SHAPES, Shape
from repro_torch.models import api, lm
from repro_torch.train import optim

__all__ = ["make_train_step", "opt_config", "Step", "mesh_device",
           "build_train", "build_prefill", "build_decode", "build_cell"]


def make_train_step(cfg, opt_cfg: optim.AdamWConfig):
    """Returns ``train_step(params, opt_state, batch, device=None) ->
    (params, opt_state, metrics)``.  The gradients come from
    ``torch.autograd.grad`` on the loss, taken with respect to detached
    copies of the parameters (no data is copied); a leaf the loss does not
    reach gets zeros, as under ``jax.grad``.  ``metrics`` holds the
    model's (``nll``, and ``aux`` where the model has one), ``grad_norm``,
    ``lr`` and ``loss``, float32 scalars on the device.  The layers'
    checkpoints (``torch.utils.checkpoint``, non-reentrant) recompute in
    the backward pass that ``autograd.grad`` runs."""
    model = api.build(cfg)

    def train_step(params, opt_state, batch, device=None):
        wrt = optim.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.loss(wrt, batch, device=device)
        grads = iter(torch.autograd.grad(loss, lm.leaves(wrt),
                                         allow_unused=True,
                                         materialize_grads=True))
        params, opt_state, om = optim.apply(
            opt_cfg, params, opt_state,
            optim.tree_map(lambda _: next(grads), wrt))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om, "loss": loss.detach()}

    return train_step


def opt_config(cfg) -> optim.AdamWConfig:
    """The builders' AdamW: bf16 moments for a model above 1e11 parameters
    (so the 200B+ model's state fits a chip), float32 otherwise."""
    big = api.count_params(cfg) > 1e11
    return optim.AdamWConfig(moment_dtype="bfloat16" if big else "float32")


def mesh_device(mesh) -> torch.device:
    """The device a step on ``mesh`` runs on: ``meta`` for an
    ``AbstractMesh``, else the one device every entry of the mesh names.
    ``NotImplementedError`` for a mesh of several distinct devices."""
    if isinstance(mesh, ctx.AbstractMesh):
        return torch.device("meta")

    def flat(grid):
        return [d for g in grid for d in flat(g)] if isinstance(
            grid, tuple) else [grid]

    devs = set(flat(mesh.devices))
    if len(devs) != 1:
        raise NotImplementedError(
            f"the mesh {mesh.shape} names {len(devs)} distinct devices "
            f"({sorted(map(str, devs))}): computing a model across several "
            f"devices is not ported (ROADMAP.md); a mesh whose entries all "
            f"name one device runs there")
    return devs.pop()


@dataclasses.dataclass(frozen=True)
class Step:
    """A step bound to a mesh.  ``fn(*args)`` checks that every input leaf
    divides under its spec (``ValueError`` otherwise), then runs
    ``step(*args, device=device)`` under ``mesh_context(mesh)``.
    ``in_specs`` mirrors the arguments, ``out_specs`` the outputs (None
    where the reference leaves the output's sharding to its compiler)."""

    step: Callable
    cfg: Any
    mesh: Any
    device: torch.device
    in_specs: tuple
    out_specs: tuple

    def __call__(self, *args):
        if len(args) != len(self.in_specs):
            raise ValueError(f"the step takes {len(self.in_specs)} "
                             f"arguments, got {len(args)}")
        sizes = ctx.mesh_sizes(self.mesh)
        for i, (arg, specs) in enumerate(zip(args, self.in_specs)):
            for path, leaf, spec in shd.spec_leaves(arg, specs, (i,)):
                shape = tuple(leaf.shape)
                if len(spec) > len(shape):
                    raise ValueError(f"argument {list(path)}: spec {spec} "
                                     f"is longer than its shape {shape}")
                for dim, entry in zip(shape, spec):
                    axes = () if entry is None else (
                        entry if isinstance(entry, tuple) else (entry,))
                    k = math.prod(sizes[a] for a in axes)
                    if dim % k:
                        raise ValueError(f"argument {list(path)}: dimension "
                                         f"{dim} of {shape} does not divide "
                                         f"over {axes} ({k}) under {spec}")
        with ctx.mesh_context(self.mesh):
            return self.step(*args, device=self.device)


def _config(arch: str, overrides: dict | None):
    cfg = configs.get(arch)
    return cfg.scaled(**overrides) if overrides else cfg


def build_train(arch: str, shape: Shape, mesh,
                opt_cfg: optim.AdamWConfig | None = None,
                overrides: dict | None = None):
    """(fn(params, opt_state, batch) -> (params, opt_state, metrics),
    (params, opt_state, batch) stand-ins)."""
    cfg = _config(arch, overrides)
    if opt_cfg is None:
        opt_cfg = opt_config(cfg)
    device = mesh_device(mesh)
    pspec = api.param_spec(cfg)
    p_sh = shd.param_specs(cfg, mesh, pspec)
    o_sh = optim.state_specs(p_sh, opt_cfg)
    batch = api.train_batch_spec(cfg, shape.global_batch, shape.seq_len)
    b_sh = shd.batch_specs(cfg, mesh, batch)
    ospec = optim.init(opt_cfg, pspec, device="meta")
    fn = Step(make_train_step(cfg, opt_cfg), cfg, mesh, device,
              (p_sh, o_sh, b_sh), (p_sh, o_sh, None))
    return fn, (pspec, ospec, batch)


def build_prefill(arch: str, shape: Shape, mesh,
                  overrides: dict | None = None):
    """(fn(params, batch, cache) -> (logits, cache), (params, batch, cache)
    stand-ins)."""
    cfg = _config(arch, overrides)
    device = mesh_device(mesh)
    model = api.build(cfg)
    pspec = api.param_spec(cfg)
    p_sh = shd.param_specs(cfg, mesh, pspec, fsdp=cfg.serve_fsdp_params)
    batch = api.prefill_batch_spec(cfg, shape.global_batch, shape.seq_len)
    b_sh = shd.batch_specs(cfg, mesh, batch)
    cspec = api.cache_spec(cfg, shape.global_batch, shape.seq_len)
    c_sh = shd.cache_specs(cfg, mesh, cspec)
    fn = Step(model.prefill, cfg, mesh, device, (p_sh, b_sh, c_sh),
              (None, c_sh))
    return fn, (pspec, batch, cspec)


def build_decode(arch: str, shape: Shape, mesh,
                 overrides: dict | None = None):
    """(fn(params, tokens, pos, cache) -> (logits, cache), (params, tokens,
    pos, cache) stand-ins)."""
    cfg = _config(arch, overrides)
    device = mesh_device(mesh)
    model = api.build(cfg)
    pspec = api.param_spec(cfg)
    p_sh = shd.param_specs(cfg, mesh, pspec, fsdp=cfg.serve_fsdp_params)
    toks, pos = api.decode_inputs_spec(cfg, shape.global_batch)
    t_sh = shd.batch_specs(cfg, mesh, {"t": toks})["t"]
    pos_sh = shd.batch_specs(cfg, mesh, {"p": pos})["p"]
    cspec = api.cache_spec(cfg, shape.global_batch, shape.seq_len)
    c_sh = shd.cache_specs(cfg, mesh, cspec)
    fn = Step(model.decode, cfg, mesh, device, (p_sh, t_sh, pos_sh, c_sh),
              (None, c_sh))
    return fn, (pspec, toks, pos, cspec)


def build_cell(arch: str, shape_name: str, mesh,
               overrides: dict | None = None):
    """Returns (fn, arg_specs) for one dry-run cell."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train(arch, shape, mesh, overrides=overrides)
    if shape.kind == "prefill":
        return build_prefill(arch, shape, mesh, overrides=overrides)
    return build_decode(arch, shape, mesh, overrides=overrides)
