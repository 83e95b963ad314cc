"""Multi-pod dry run: plan every (arch x shape x mesh) cell without devices.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 256 or 512 forced host devices; the port builds each cell's
step (``launch.steps.build_cell``) for an ``AbstractMesh`` of the
production shape, which proves the specs divide every input, and counts
it on ``meta`` stand-ins (``launch.op_cost``, loop-aware; nothing is
allocated).  A record keeps the reference's keys: ``arch shape mesh chips
status``, then ``reason`` for a skipped cell, or ``roofline`` (per device,
``launch.roofline``), ``xla_cost`` (``None``: XLA's own loop-body-once
analysis has no counterpart), ``memory`` and ``compile_s`` (the cell's
wall time).  The global count of a cell depends on (arch, shape) only,
so both meshes share it.  A cell that fails raises: the port has no
``except`` clause that could hide a fault (the reference records an
``error`` status).

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multipod both
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import re
import time

from repro_torch import configs
from repro_torch.dist import ctx
from repro_torch.launch import cells, op_cost, roofline, steps

__all__ = ["production_mesh", "run_cell", "main"]


def production_mesh(multi_pod: bool) -> ctx.AbstractMesh:
    """The production mesh's axes without devices: (16, 16) over
    ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")``."""
    if multi_pod:
        return ctx.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return ctx.abstract_mesh((16, 16), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _global_costs(arch: str, shape: str, overrides: tuple) -> tuple:
    c = op_cost.cell_costs(arch, cells.SHAPES[shape],
                           dict(overrides) or None)
    return c.flops, c.bytes, c.unread


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             overrides: dict | None = None, tag: str = "") -> dict:
    t0 = time.time()
    mesh = production_mesh(multi_pod)
    rec = {
        "arch": configs.canonical(arch), "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
    }
    if overrides:
        rec["overrides"] = overrides
    if tag:
        rec["tag"] = tag
    reason = cells.skip_reason(arch, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    fn, arg_specs = steps.build_cell(arch, shape, mesh, overrides=overrides)
    flops, nbytes, unread = _global_costs(
        configs.canonical(arch), shape,
        tuple(sorted((overrides or {}).items())))
    sh = cells.SHAPES[shape]
    rl = roofline.analyze(op_cost.Costs(flops, nbytes), fn, arg_specs, sh)
    rec.update(
        status="ok",
        roofline=rl.as_dict(),
        xla_cost=None,
        memory=roofline.memory_summary(fn, arg_specs, sh, unread),
        compile_s=round(time.time() - t0, 1),
    )
    return rec


def _value(v: str):
    """An override's value: an int, else a float, else the string, as the
    reference's parse tries them."""
    if re.fullmatch(r"[+-]?\d+", v):
        return int(v)
    if re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", v):
        return float(v)
    return v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(cells.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. --override ssm_chunk=64")
    ap.add_argument("--tag", default="", help="label for perf iterations")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = _value(v)

    todo = (cells.all_cells() if args.all
            else [(args.arch, args.shape or s) for s in
                  ([args.shape] if args.shape else list(cells.SHAPES))])
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multipod]

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for arch, shape in todo:
            for mp in pods:
                rec = run_cell(arch, shape, multi_pod=mp,
                               overrides=overrides or None, tag=args.tag)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                status = rec["status"]
                extra = (rec["roofline"]["dominant"] if status == "ok"
                         else rec["reason"])
                print(f"[{rec['mesh']:8s}] {rec['arch']:18s} {shape:12s} "
                      f"{status:8s} {extra}", flush=True)


if __name__ == "__main__":
    main()
