"""Checkpoints with an atomic commit, and resume from the newest one.

The port of ``repro.train.checkpoint``, in the reference's layout, so a
checkpoint written by either package restores in the other::

    ckpt_dir/
      step_00000100/
        meta.json            # step, n_leaves, treedef, dtypes, extra metadata
        shard_0.npz          # leaf_0, leaf_1, ... in flattening order
        COMMITTED            # written last: a step without it is ignored

- a step is written as ``step_X.tmp`` and renamed once ``COMMITTED`` is
  in it, so a crash mid-write leaves no committed step;
- ``latest_step`` finds the newest committed step, from which a restarted
  job resumes (the data pipeline is seekable, ``data.pipeline``);
- leaves are flattened as ``jax.tree_util`` flattens the same tree: a
  dict's keys in sorted order, a list's or tuple's entries in order;
- bfloat16, which ``.npz`` cannot hold, is stored as its 16 bits
  (``uint16``) with ``"bfloat16"`` in ``dtypes``, through torch's own
  ``view``.

One process writes ``shard_0.npz``: the port's meshes are driven by one
process, as the reference's single-host path is.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import torch

__all__ = ["save", "latest_step", "restore", "prune"]

_HOST = 0   # the shard this process writes: one process drives the mesh


def _flatten(tree) -> tuple[list, str]:
    """The leaves of a tree of dicts, lists and tuples in ``jax.tree_util``'s
    order, and its structure written as ``str(PyTreeDef)`` writes it."""
    leaves = []

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            return (f"[{inner}]" if isinstance(t, list)
                    else f"({inner}{',' if len(t) == 1 else ''})")
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` in its flattening order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_savable(t: torch.Tensor) -> np.ndarray:
    """A host NumPy copy; bfloat16 as its 16 bits (``uint16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_savable(x: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def save(ckpt_dir: str | pathlib.Path, step: int, tree,
         extra_meta: dict | None = None) -> pathlib.Path:
    """Write ``tree`` (tensors) as step ``step`` and commit it; returns its
    directory.  A committed step of the same number is replaced."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, treedef = _flatten(tree)
    np.savez(tmp / f"shard_{_HOST}.npz",
             **{f"leaf_{i}": _to_savable(t) for i, t in enumerate(leaves)})
    meta = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": treedef,
        "dtypes": [_dtype_name(t) for t in leaves],
        **(extra_meta or {}),
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _committed(ckpt_dir: pathlib.Path) -> list[int]:
    return [int(d.name.split("_")[1]) for d in ckpt_dir.glob("step_*")
            if d.suffix != ".tmp" and (d / "COMMITTED").exists()]


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    """The newest committed step, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _committed(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str | pathlib.Path, step: int, like_tree):
    """Step ``step`` in the structure of ``like_tree``, each leaf in its
    saved dtype on the device of ``like_tree``'s leaf.  Raises
    ``FileNotFoundError`` where the step is not committed."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    meta = json.loads((d / "meta.json").read_text())
    dtypes = meta.get("dtypes", [])
    like, _ = _flatten(like_tree)
    with np.load(d / f"shard_{_HOST}.npz") as data:
        restored = []
        for i, leaf in enumerate(like):
            x = data[f"leaf_{i}"]
            t = (_from_savable(x, dtypes[i]) if i < len(dtypes)
                 else torch.from_numpy(x))
            restored.append(t.to(leaf.device))
    return _unflatten(like_tree, restored)


def prune(ckpt_dir: str | pathlib.Path, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed steps."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    for s in sorted(_committed(ckpt_dir))[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
