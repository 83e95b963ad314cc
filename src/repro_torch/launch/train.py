"""The training loop, end to end, with checkpoint and restart.

The port of ``repro.launch.train`` on one card: the same flags and loop.
Seeded init (``torch.Generator().manual_seed(0)``, so the weights are the
same on every device), resume from the newest committed checkpoint, the
seekable data pipeline replayed from there, a log line every
``--log-every`` steps and at the last, and an atomic checkpoint (then
pruned to 3) every ``--ckpt-every`` steps.  ``--mesh production`` asks
for the 256 devices of the production mesh and is refused on fewer.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 200 --batch 8 --seq 512 --ckpt-dir /tmp/ckpt

runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.dist import ctx
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.rebalance.planner import resolve_device
from repro_torch.train import checkpoint, optim


def main(argv=None, device=None) -> dict:
    """Train as the flags say; returns {"first_loss", "last_loss",
    "params"} (the losses of the first and last steps this call ran, None
    where it ran none).  ``device=None`` means the card (``RuntimeError``
    where CUDA is absent)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--wd", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="local", choices=["local", "production"])
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    model = api.build(cfg)
    opt_cfg = optim.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                weight_decay=args.wd)
    mesh = (make_production_mesh(device=device)
            if args.mesh == "production" else make_local_mesh(device))

    data = TokenPipeline(cfg, DataConfig(
        global_batch=args.batch, seq_len=args.seq))

    with ctx.mesh_context(mesh):
        params = model.init(torch.Generator().manual_seed(0), device=dev)
        opt_state = optim.init(opt_cfg, params, device=dev)
        step_fn = make_train_step(cfg, opt_cfg)

        start = 0
        if args.ckpt_dir:
            latest = checkpoint.latest_step(args.ckpt_dir)
            if latest is not None:
                state = checkpoint.restore(
                    args.ckpt_dir, latest,
                    {"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                start = latest
                print(f"resumed from step {start}")

        losses = []
        t0 = time.time()
        for step in range(start, args.steps):
            params, opt_state, metrics = step_fn(
                params, opt_state, data.batch_at(step), device=dev)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"({dt / max(step - start + 1, 1):.2f}s/step)",
                      flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoint.save(args.ckpt_dir, step + 1,
                                {"params": params, "opt": opt_state},
                                {"arch": cfg.name})
                checkpoint.prune(args.ckpt_dir)

    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "params": params}


if __name__ == "__main__":
    out = main()
    print(f"final: first={out['first_loss']:.4f} last={out['last_loss']:.4f}")
