"""What the kernels' compare tools share: build sources with ``nvcc``,
read their SASS, and time calls on the card.

``flash/compare.py`` and ``probe/compare.py`` hold builds of one CUDA
source against each other (this checkout's, an older commit's, an edited
copy) on one card; this module holds the parts that do not depend on the
kernel.  Nothing here runs when it is imported.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import time
from typing import Callable

import torch

from . import _build

REPS = 20


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return str(pathlib.Path(CUDA_HOME) / "bin" / name)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(builds: dict, out_dir: pathlib.Path,
          entries: tuple[str, ...]) -> tuple[dict, dict]:
    """``nvcc`` every source of ``builds`` (name -> path) at once, each
    into ``out_dir/<name>.so`` with the flags of the real build (sm_90a
    only, -O3, no implicit half or bf16 conversions) and ``-Xptxas -v``;
    returns the libraries with ``entries`` bound as ``_build`` declares
    them, and each build's ``ptxas`` lines."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        so = out_dir / f"{name}.so"
        cmd = [_tool("nvcc"), "-gencode=arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-D__CUDA_NO_HALF_OPERATORS__",
               "-D__CUDA_NO_HALF_CONVERSIONS__",
               "-D__CUDA_NO_BFLOAT16_CONVERSIONS__",
               "-D__CUDA_NO_HALF2_OPERATORS__", "-shared", "-Xcompiler",
               "-fPIC", "-cudart", "shared", "-Xptxas", "-v", "-o", str(so),
               str(src)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-6000:]}")
        ptxas[name] = [ln.split("ptxas info    :")[-1].strip()
                       for ln in out.splitlines() if "Used" in ln
                       or "Compiling entry" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        for fn in entries:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def sass(so: pathlib.Path, rename: Callable[[str], str]) -> dict:
    """Each kernel's SASS instructions (addresses and encodings dropped),
    by its demangled name passed through ``rename`` (the anonymous
    namespace already dropped)."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                  text=True).stdout.strip()
            cur = rename(name.replace("(anonymous namespace)::", ""))
            funcs[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            funcs[cur].append(re.sub(r"/\*.*?\*/|;", "", line).strip())
    return funcs


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn`` (ms), as ``chip_smoke.py`` takes
    it: ``reps`` calls queued behind a sleep kernel, timed by events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * enqueue_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base lies one element past the
    start of its buffer, so not on a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)
