"""Wrappers of the SAT kernels: Gamma of a 2D frame or stack (K1,
``sat.cu``) and of a 3D volume or stack (K4, ``sat3d.cu``).

A CUDA tensor goes through a kernel, a CPU tensor through the plain
version in ``ref.py``; there is no other route.  :func:`gamma` takes a
``(n1, n2)`` frame or a ``(B, n1, n2)`` stack, :func:`gamma3` a
``(n1, n2, n3)`` volume or a ``(B, n1, n2, n3)`` stack (separate names,
because a rank-3 input is either), of int32 or float32 loads; K1 also
takes float64 (the heuristic planner's float64 accumulators).

Both kernels cut the frames into bands and run a reduce, then a scan
(``sat_scan.cuh``); the wrappers allocate the scratch that carries the
bands' sums from one to the other, and :func:`band_rows` and
:func:`sat3_plan` choose the bands.  K4 has two routes, each counted under
its own launch key: ``sat3`` for planes ``(n2, n3)`` that fit one block
(:data:`SAT3_CLASSES`), a reduce over bands of slabs and then a scan;
``sat3_general`` for the rest, a scan down the slabs and then K1's reduce
and scan on every plane in place.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import gamma3_ref, gamma_ref

_FN = {torch.float32: "repro_sat_gamma_f32", torch.int32: "repro_sat_gamma_i32",
       torch.float64: "repro_sat_gamma_f64"}
_FN3 = {torch.float32: "repro_sat3_gamma_f32",
        torch.int32: "repro_sat3_gamma_i32"}
_FN3G = {torch.float32: "repro_sat3_general_f32",
         torch.int32: "repro_sat3_general_i32"}
#: dtype of the carries in scratch: float64 sums, or the bits of uint32 sums
_ACC = {torch.float32: torch.float64, torch.int32: torch.int32,
        torch.float64: torch.float64}

#: granule of K1's band heights: a sub-band of the reduce, and a multiple
#: of the scan's 16-row tiles
TILE_ROWS = 32
#: most rows in a band (the scan keeps a row carry per band row in shared
#: memory when a row spans more than one chunk of columns)
BAND_ROWS_MAX = 8192
#: rows of a sub-band of the reduce (sat_scan.cuh: kSub)
SUB_ROWS = 32
#: K4's plane classes: columns per lane c, for planes with n3 <= 32 c and
#: n2 <= 512 / c (sat3d.cu: a block holds 512 / c plane rows)
SAT3_CLASSES = (1, 2, 4, 8)
#: fewest slabs in a band of K4 (below it the float64 carries outweigh the
#: slabs; 4 was the fastest at B = 1 on the H100)
MIN_SLABS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def band_rows(F: int, rows: int, sms: int) -> int:
    """Rows per band for K1's reduce and scan over ``F`` planes of
    ``rows`` rows: a multiple of :data:`TILE_ROWS`, with about two blocks
    of the scan per SM where the rows allow it."""
    want = _cdiv(2 * sms, max(F, 1))
    R = _cdiv(_cdiv(max(rows, 1), want), TILE_ROWS) * TILE_ROWS
    return min(R, BAND_ROWS_MAX)


def sat3_plan(B: int, n1: int, n2: int, n3: int,
              sms: int) -> tuple[str, int, int]:
    """K4's route for a ``(B, n1, n2, n3)`` stack: ``("sat3", c, S)`` with
    the plane class ``c`` and ``S`` slabs per band (about one block of the
    scan per SM, and at least :data:`MIN_SLABS`), or ``("sat3_general", 0,
    R)`` with K1's band height over the planes."""
    for c in SAT3_CLASSES:
        if n3 <= 32 * c and n2 <= 512 // c:
            n = max(n1, 1)
            S = _cdiv(n, max(1, min(n, sms // max(B, 1))))
            return "sat3", c, max(S, min(MIN_SLABS, n))
    return "sat3_general", 0, band_rows(B * n1, n2, sms)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_dtype(name: str, a: torch.Tensor, fns: dict) -> None:
    if a.dtype not in fns:
        kinds = " or ".join(str(d).removeprefix("torch.") for d in fns)
        raise TypeError(f"{name} takes {kinds} loads, got {a.dtype}")


def _sums(x: torch.Tensor, planes: int, rows: int, R: int,
          cols: int) -> torch.Tensor:
    """Scratch of the reduce: every band below the last (bands of ``R`` of
    the ``rows``) in sub-bands of at most :data:`SUB_ROWS` rows, summed over
    each of ``cols`` columns of each plane."""
    sub = (max(1, _cdiv(rows, R)) - 1) * _cdiv(R, SUB_ROWS)
    return torch.empty((planes, sub, cols), dtype=_ACC[x.dtype],
                       device=x.device)


def gamma(a: torch.Tensor) -> torch.Tensor:
    """The paper's Gamma array: exclusive prefix, shape (..., n1+1, n2+1),
    in ``a``'s dtype (int32, float32 or float64)."""
    if a.ndim not in (2, 3):
        raise ValueError(f"gamma takes (n1, n2) or (B, n1, n2), got {a.ndim}D")
    _check_dtype("gamma", a, _FN)
    if _build.on_cpu("sat", a):
        return gamma_ref(a)
    x = a.contiguous()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    B, n1, n2 = x.shape
    _build.check_cuda("sat", x)
    g = torch.empty((B, n1 + 1, n2 + 1), dtype=x.dtype, device=x.device)
    R = band_rows(B, n1, _sms(x.device))
    E = _sums(x, B, n1, R, n2)
    _build.launch("sat", _FN[x.dtype], x, g, E, B, n1, n2, R)
    return g[0] if squeeze else g


def sat(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 2D prefix sum (a view into :func:`gamma`'s result)."""
    return gamma(a)[..., 1:, 1:]


def gamma3(a: torch.Tensor) -> torch.Tensor:
    """Exclusive 3D prefix, shape (..., n1+1, n2+1, n3+1), in ``a``'s
    dtype."""
    if a.ndim not in (3, 4):
        raise ValueError(f"gamma3 takes (n1, n2, n3) or (B, n1, n2, n3), "
                         f"got {a.ndim}D")
    _check_dtype("gamma3", a, _FN3)
    if _build.on_cpu("sat3", a):
        return gamma3_ref(a)
    x = a.contiguous()
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    B, n1, n2, n3 = x.shape
    _build.check_cuda("sat3", x)
    g = torch.empty((B, n1 + 1, n2 + 1, n3 + 1), dtype=x.dtype,
                    device=x.device)
    route, c, band = sat3_plan(B, n1, n2, n3, _sms(x.device))
    if route == "sat3":
        E = _sums(x, B, n1, band, n2 * n3)
        _build.launch("sat3", _FN3[x.dtype], x, g, E, B, n1, n2, n3, band, c)
    else:
        E = _sums(x, B * n1, n2, band, n3)
        _build.launch("sat3_general", _FN3G[x.dtype], x, g, E, B, n1, n2,
                      n3, band)
    return g[0] if squeeze else g


def sat3(a: torch.Tensor) -> torch.Tensor:
    """Inclusive 3D prefix sum (a view into :func:`gamma3`'s result)."""
    return gamma3(a)[..., 1:, 1:, 1:]
