"""AdamW over the reference's parameter trees, with the error-feedback
gradient-compression hook.

The port of ``repro.train.optim``, arithmetic for arithmetic: the
gradients' global norm over every leaf in float32 and the clip
``min(1, grad_clip / max(norm, 1e-8))``; moments kept in ``moment_dtype``
and updated in float32; bias corrections ``1 - b ** float32(step)``; the
update in float32, cast back to each parameter's dtype.  Weight decay
applies where ``p.ndim >= 2`` (P20): the per-layer leaves are stacked on
a leading L axis, so every layer's norm scale ``(L, d)`` is decayed,
while the final ``ln_f`` ``(d,)`` is not.

``torch.optim.AdamW`` is not used: it clips nothing, decays every leaf
and computes in the parameter's dtype.  ``apply`` runs under
``torch.no_grad()`` and returns new tensors; nothing is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.dist.ctx import P
from repro_torch.models import lm
from repro_torch.rebalance.planner import resolve_device

__all__ = ["AdamWConfig", "init", "apply", "compress_decompress",
           "state_specs", "state_from_numpy", "tree_map"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # 'bfloat16' for the largest models
    warmup_steps: int = 100
    # error-feedback int8 gradient compression for the DP all-reduce
    compress_grads: bool = False


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _mdt(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _moments(cfg: AdamWConfig) -> list[str]:
    return ["m", "v", "err"] if cfg.compress_grads else ["m", "v"]


def init(cfg: AdamWConfig, params: Any, device=None) -> dict:
    """Zero moments of the parameters' shapes in ``moment_dtype`` (and the
    compression residual ``err`` where ``compress_grads``), and an int32
    ``step`` of 0, on ``device``, where the parameters must already be
    (``ValueError`` otherwise)."""
    dev = torch.empty(0, device=resolve_device(device)).device
    for t in lm.leaves(params):
        if t.device != dev:
            raise ValueError(f"params must be on {dev}, found a tensor on "
                             f"{t.device}")
    state = {k: tree_map(lambda p: torch.zeros(p.shape, dtype=_mdt(cfg),
                                               device=dev), params)
             for k in _moments(cfg)}
    state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8 quantisation with one scale a tensor: returns
    (the dequantised gradient, the residual carried to the next step),
    both in ``g``'s dtype."""
    g = g + err.to(g.dtype)
    scale = torch.clamp(g.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(g.dtype) * scale
    return deq, g - deq


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Any, state: dict, grads: Any
          ) -> tuple[Any, dict, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}), the
    metrics float32 scalars."""
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    new_state = {"step": step}
    if cfg.compress_grads:
        pairs = tree_map(compress_decompress, grads, state["err"])
        grads = tree_map(lambda pr: pr[0], pairs)
        new_state["err"] = tree_map(lambda pr: pr[1], pairs)

    gnorm = 0
    for g in lm.leaves(_sorted(grads)):
        gnorm = gnorm + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(gnorm)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-8), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, m, v, g):
        g = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only (P20)
            u = u + cfg.weight_decay * p.float()
        newp = p.float() - lr * u
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, state["m"], state["v"], grads)
    new_params = tree_map(lambda t: t[0], out)
    new_state["m"] = tree_map(lambda t: t[1], out)
    new_state["v"] = tree_map(lambda t: t[2], out)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order, the order in which
    ``jax.tree_util`` flattens it (the norm's sum runs in that order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def state_specs(param_specs: Any, cfg: AdamWConfig) -> dict:
    """Optimizer-state specs mirroring the parameter specs: the moments
    (and ``err``) shard as the parameters, the step is replicated
    (``P()``)."""
    st = {"m": param_specs, "v": param_specs, "step": P()}
    if cfg.compress_grads:
        st["err"] = param_specs
    return st


def state_from_numpy(tree, cfg: AdamWConfig, params: Any,
                     device=None) -> dict:
    """The reference's AdamW state (``m``, ``v``, ``step``, and ``err``
    where ``compress_grads``; NumPy arrays, bfloat16 moments as float32)
    as the port's on ``device``: each moment in ``moment_dtype`` and of
    its parameter's shape, ``step`` int32.  Raises ``ValueError`` where
    the keys or shapes are not those of ``params`` and ``cfg``."""
    dev = resolve_device(device)
    want = set(_moments(cfg)) | {"step"}
    if set(tree) != want:
        raise ValueError(f"state keys {sorted(tree)}, expected {sorted(want)}")

    def conv(s, a, path):
        if isinstance(s, dict):
            if not isinstance(a, dict) or set(a) != set(s):
                raise ValueError(f"state{path}: keys do not match the "
                                 f"params'")
            return {k: conv(s[k], a[k], f"{path}[{k!r}]") for k in s}
        t = torch.tensor(np.asarray(a))
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"state{path}: shape {tuple(t.shape)}, "
                             f"expected {tuple(s.shape)}")
        return t.to(device=dev, dtype=_mdt(cfg))

    state = {k: conv(params, tree[k], f"[{k!r}]") for k in _moments(cfg)}
    state["step"] = torch.tensor(np.asarray(tree["step"]),
                                 dtype=torch.int32, device=dev).reshape(())
    return state
