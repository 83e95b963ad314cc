"""Time builds of K2's CUDA source against each other on the card.

Run from the root of a checkout on a machine with an NVIDIA H100::

    PYTHONPATH=src python -m repro_torch.kernels.probe.compare \\
        --build parent=build/parent/probe.cu

This checkout's ``probe.cu`` is always built, as ``this``, and each
``--build NAME=PATH`` adds another source (an older commit's, or an
edited copy).  ``nvcc`` builds every source at once,
each into a shared library of its own under ``build/probe_compare/``
(its C entry points as ``kernels/_build.py`` declares them), with
``-Xptxas -v``.  Then, on one card:

- the general route (``repro_probe_general_i32``) at the exact 1D
  solver's first bisection round: the (1, 1048577) int32 row that
  ``chip_smoke.py``'s registry phase makes (the same draws), the 15
  candidates that ``core.device.nicol_optimal_device_impl`` probes first
  (taken on the CPU), cap 1024;
- the staged route (``repro_probe_counts_i32``) at (2048, 513) int32
  rows x 8 candidates, cap 32 (loads in [0, 40), candidates up to twice
  a row's total over 32);
- each build's counts at both shapes equal to the plain version's (the
  wrapper on CPU tensors), and each build's staged kernels' SASS
  (``cuobjdump -sass``) against ``this``'s.

Times are device times per call (CUDA events over 20 calls queued
behind a sleep kernel), taken in turns: the builds in order, then
in reverse (parent, this, this, parent).  The longest walk's steps and
the time per step of it are printed beside the general route's times.
The last line is one JSON object with every number; the card's name and
power limit come first.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from .. import _build, _compare

_HERE = pathlib.Path(__file__).resolve().parent
OUT_DIR = _build.BUILD_DIR.parent / "probe_compare"
N_1D, M_1D = 1_048_576, 1024   # the 1D solver's row and parts
STAGED = (2048, 513, 8, 32)              # S, n + 1, K, cap
_ENTRY = ("repro_probe_counts_i32", "repro_probe_general_i32")


def solver_row() -> np.ndarray:
    """The exact 1D solver's long row, drawn as ``chip_smoke.py``'s
    registry phase draws it (seed 2: the 1024 speeds and their dead
    parts, the 4,096-entry row, then this one)."""
    rng = np.random.default_rng(2)
    rng.uniform(0.25, 4.0, M_1D)
    rng.choice(M_1D, 8, replace=False)
    for n in (4096, N_1D):
        loads = rng.integers(0, 1000, n)
        loads[rng.choice(n, 16, replace=False)] = 200_000
    return np.concatenate([[0], np.cumsum(loads)]).astype(np.int32)


def first_round(row: np.ndarray) -> torch.Tensor:
    """The (1, 15) candidates of the solver's first bisection round."""
    from ...core import device
    from . import ops

    seen = []
    launch = ops.probe_counts

    def tap(p, Ls, cap):
        seen.append(Ls.clone())
        return launch(p, Ls, cap)

    ops.probe_counts = tap
    try:
        device.nicol_optimal_device_impl(torch.from_numpy(row), M_1D)
    finally:
        ops.probe_counts = launch
    return seen[0]


def walk_steps(p: torch.Tensor, Ls: torch.Tensor, cap: int) -> torch.Tensor:
    """The greedy steps each walk takes (S, K): its advances, as the plain
    version's loop counts them before the clamp and the sentinel."""
    n = p.shape[-1] - 1
    pos = torch.zeros(Ls.shape, dtype=torch.int64, device=p.device)
    steps = torch.zeros(Ls.shape, dtype=torch.int64, device=p.device)
    for _ in range(cap):
        nxt = torch.searchsorted(p, p.gather(-1, pos) + Ls, right=True) - 1
        adv = (pos < n) & (nxt.clamp_max(n) > pos)
        pos = torch.where(adv, nxt.clamp_max(n), pos)
        steps += adv
    return steps


def staged_case() -> tuple[torch.Tensor, torch.Tensor]:
    S, n_plus_1, K, cap = STAGED
    rng = np.random.default_rng(0)
    loads = rng.integers(0, 40, (S, n_plus_1 - 1))
    p = np.zeros((S, n_plus_1), np.int64)
    p[:, 1:] = np.cumsum(loads, axis=1)
    Ls = rng.integers(0, 2 * p[:, -1:] // cap + 2, (S, K))
    return (torch.from_numpy(p.astype(np.int32)),
            torch.from_numpy(Ls.astype(np.int32)))


def call(lib, fn: str, p, Ls, cap: int, out) -> None:
    S, n_plus_1 = p.shape
    err = getattr(lib, fn)(p.data_ptr(), Ls.data_ptr(), out.data_ptr(), S,
                           n_plus_1, Ls.shape[1], cap,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _staged_name(name: str) -> str:
    """A kernel's name with the template's bool argument dropped."""
    return name.replace(", true>", ">")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="NAME=PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: CUDA is not available; this script runs on the "
              "card only")
        return 1
    builds = {"this": _HERE / "probe.cu"}
    for spec in args.build:
        name, path = spec.split("=", 1)
        builds[name] = pathlib.Path(path)
    card = _compare.card()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs, ptxas = _compare.build(builds, OUT_DIR, _ENTRY)
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, lines in ptxas.items():
        print(f"ptxas {name}: " + " | ".join(lines), flush=True)

    cuda = torch.device("cuda")
    row = solver_row()
    cand = first_round(row)
    p1 = torch.from_numpy(row)[None]
    steps = walk_steps(p1, cand, M_1D)
    cases = {"general": (_ENTRY[1], p1, cand, M_1D),
             "staged": (_ENTRY[0], *staged_case(), STAGED[3])}
    record = {"card": card, "reps": _compare.REPS,
              "longest_walk_steps": int(steps.max()),
              "greedy_steps": int(steps.sum()), "ms": {}, "ptxas": ptxas}
    from . import ops
    for case, (fn, p, Ls, cap) in cases.items():
        want = ops.probe_counts(p, Ls, cap)         # the plain version
        p, Ls = p.to(cuda), Ls.to(cuda)
        out = torch.empty(Ls.shape, dtype=torch.int32, device=cuda)
        for name, lib in libs.items():
            out.fill_(-1)
            call(lib, fn, p, Ls, cap, out)
            torch.cuda.synchronize()
            err = int((out.cpu() - want).abs().max())
            if err:
                raise RuntimeError(f"{name} {case}: differs from the plain "
                                   f"version by {err}")
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(_compare.device_ms(
                lambda lib=libs[name]: call(lib, fn, p, Ls, cap, out)))
        record["ms"][case] = times
        for name, ts in times.items():
            extra = ""
            if case == "general":
                extra = (f"; longest walk {int(steps.max())} steps, "
                         f"{min(ts) * 1e3 / int(steps.max()):.3f} us a step")
            print(f"{case} {tuple(p.shape)} x {Ls.shape[1]}, cap {cap}: "
                  f"{name} " + ", ".join(f"{t:.4f}" for t in ts)
                  + f" ms (plain version equal){extra}", flush=True)
    this = _compare.sass(OUT_DIR / "this.so", _staged_name)
    record["staged_sass_equal"] = {}
    for name in [n for n in libs if n != "this"]:
        other = _compare.sass(OUT_DIR / f"{name}.so", _staged_name)
        for dt in ("int", "float"):
            key = f"probe_kernel<{dt}>"
            a = [v for k, v in this.items() if key in k]
            b = [v for k, v in other.items() if key in k]
            same = len(a) == len(b) == 1 and a[0] == b[0]
            record["staged_sass_equal"][f"{name} {dt}"] = same
            print(f"staged {key} SASS: {name} {'=' if same else '!='} "
                  f"this ({len(b[0]) if b else 0} instructions)", flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
