"""The train step.

The port of ``repro.launch.steps.make_train_step``: the model's loss, its
gradients by autograd, then one AdamW step.  The sharded builders
(``build_train``, ``build_prefill``, ``build_decode``, ``build_cell``)
compile for a mesh of many chips and wait for the sharding specs.
"""
from __future__ import annotations

import torch

from repro_torch.models import api, lm
from repro_torch.train import optim

__all__ = ["make_train_step"]


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
