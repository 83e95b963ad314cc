"""Build, bind and count the port's hand-written CUDA kernels.

The ``.cu`` sources beside each kernel's ``ops.py`` export plain C entry
points (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).  At
the first launch :func:`library` compiles all of them in one
``torch.utils.cpp_extension.load`` call (``-gencode=arch=compute_90a,
code=sm_90a``: sm_90a code only, since ``-arch=sm_90a`` also emits
compute_90 PTX, where ``wgmma`` and ``setmaxnreg`` do not exist; ninja builds
the sources in parallel) into ``build/repro_torch_kernels/`` at the root
of the checkout, then binds the shared library with ``ctypes``.  Nothing
is built when a module is imported: the CPU tests import every module and
never reach this file's build.

Every wrapper adds one to :data:`launches` under its kernel's name where it
launches, and nowhere else, so a run can show which kernels its main path
went through.
"""
from __future__ import annotations

import collections
import ctypes
import os
import pathlib

import torch

_HERE = pathlib.Path(__file__).resolve().parent
#: kernel name -> its source (K1-K5, and K5's realigning copy)
SOURCES = {"sat": _HERE / "sat" / "sat.cu",
           "probe": _HERE / "probe" / "probe.cu",
           "rectload": _HERE / "rectload" / "rectload.cu",
           "sat3": _HERE / "sat" / "sat3d.cu",
           "flash": _HERE / "flash" / "flash.cu",
           "flash_realign": _HERE / "flash" / "realign.cu"}
BUILD_DIR = _HERE.parents[2] / "build" / "repro_torch_kernels"

#: Kernel launches by kernel name (``sat``, ``rectload``; K2 by route:
#: ``probe`` for rows that fit shared memory, ``probe_general`` for the
#: rest; K4 by route: ``sat3`` for planes that fit a block, ``sat3_general``
#: for the rest; K5 by route: ``flash`` and ``flash_f16`` for the Hopper
#: kernel at bf16 and float16, ``flash_general`` and ``flash_f16_general``
#: for the general kernel at bf16 and float16, ``flash_f32`` for float32,
#: each at d <= 256; above, at every dtype, ``flash_wide`` for the kernels
#: that compute S once a key tile in one block (what TMA can describe, d <=
#: 576), ``flash_wide_cluster`` for those that compute it once across a
#: thread-block cluster (576 < d <= 4096), other shapes up to d = 4096 after
#: ``flash_realign``, the copy into padded, aligned scratch, one launch a
#: tensor copied, and ``flash_wide_general`` for the rest: d > 4096 and
#: Skv = 0).
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types; every entry point returns cudaError_t
# but repro_flash_cluster_blocks (a count)
_SIGNATURES = {
    "repro_sat_gamma_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_sat_gamma_i32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_sat_gamma_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_sat3_gamma_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_sat3_gamma_i32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_sat3_gamma_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_sat3_general_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_sat3_general_i32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_sat3_general_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_probe_counts_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_probe_counts_i32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_probe_general_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_probe_general_i32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_rectload_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_rectload_i32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_flash_attn_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                             _P],
    "repro_flash_attn_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                              _P],
    "repro_flash_attn_f16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                             _P],
    "repro_flash_realign": [_P, _P, _I, _I, _I, _I, _P],
    "repro_flash_cluster_blocks": [_I, _I],
    "repro_flash_cluster_seen": [ctypes.POINTER(_I)],
}

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The compiled kernels (built on first call, then cached)."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import load
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = load(name="repro_torch_kernels",
                    sources=[str(s) for s in SOURCES.values()],
                    build_directory=str(BUILD_DIR),
                    extra_cuda_cflags=["-O3",
                                       "-gencode=arch=compute_90a,code=sm_90a"],
                    is_python_module=False, verbose=False)
        lib = ctypes.CDLL(path)
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str | tuple[str, ...], fn: str, *args) -> None:
    """Call C entry point ``fn`` of ``kernel`` on the current stream.

    Tensors are passed by data pointer, Python floats as C floats and
    everything else as C ints; the stream is appended.  An entry point
    that chooses among several kernels is given their names as a tuple
    and returns ``-i`` after launching the ``i``-th (0 for the first);
    the launch is counted under that name.  Raises ``RuntimeError`` when
    the launch is refused (the C side returns ``cudaGetLastError()``, a
    positive code, right after its launches).
    """
    names = (kernel,) if isinstance(kernel, str) else kernel
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else ctypes.c_float(a) if isinstance(a, float) else int(a)
            for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    ret = getattr(lib, fn)(*conv, stream)
    if ret > 0 or -ret >= len(names):
        raise RuntimeError(f"{names[0]} kernel ({fn}) failed to launch: "
                           f"CUDA error {ret}")
    launches[names[-ret]] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """Dispatch rule of every wrapper: True for a CPU tensor (the plain
    version runs), False for a CUDA tensor (the kernel runs); any other
    device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")
