"""Hold builds of K5's CUDA source against each other on the card.

Run from the root of a checkout on a machine with an NVIDIA H100::

    PYTHONPATH=src python -m repro_torch.kernels.flash.compare \\
        --build parent=build/parent/flash.cu

This checkout's ``flash.cu`` is always built, as ``this``, and each
``--build NAME=PATH`` adds another source (an older commit's, or an
edited copy).  ``--breakdown`` adds ``BREAKDOWN``'s copies of this
checkout's ``flash.cu``, timed but not held to ``this``'s output: the
wide Hopper kernel without its S products, without its P V products,
without either, and without its K and V loads (its producer arrives on
the full barriers at once), which PERF.md's breakdown of ``flash_wide``
reads; the 16-bit cluster kernel without its cluster exchange (each
block's S its own partial) and without its products.  ``nvcc``
builds every source at once, each into a shared library of its own
under ``build/flash_compare/`` (its C entry points as
``kernels/_build.py`` declares them), with ``-Xptxas -v``.  Then, on one
card:

- each build's SASS (``cuobjdump -sass``) against ``this``'s for every
  K5 kernel either build has (24 in this checkout: the Hopper kernel
  ``flash_wgmma_kernel`` and the general kernel ``flash_general_kernel``
  at each compiled width at bfloat16 and float16, ``flash_f32_kernel`` at
  each width, the wide Hopper kernel ``flash_wide_wgmma_kernel`` at
  bfloat16 and float16, ``flash_wide_f32_kernel``, the cluster kernels
  ``flash_wide_cluster_kernel`` at bfloat16 and float16 and
  ``flash_wide_cluster_f32_kernel``, and the general wide kernel
  ``flash_wide_kernel`` at each dtype);
- ``repro_flash_attn_bf16`` at ``chip_smoke.py``'s three K5 shapes
  (Gemma-2-9B local and global, Qwen3-0.6B; B=1, S=8192, 16 heads,
  causal), on aligned inputs (the Hopper kernel, return code 0) and on
  copies one element past a 16-byte boundary (the general kernel, -1),
  each build's output finite and held to ``this``'s (rtol = atol = 2e-2,
  the bf16 contract; ``chip_smoke.py`` holds ``this`` to the plain
  version), with the largest difference printed, and timed;
- the wide route at ``chip_smoke.py``'s d = 576 shape, (16, 4096, 576)
  causal, at bfloat16, float16 and float32: on aligned inputs
  (``flash_wide``, return code -2 at 16 bits, -1 at float32) and on
  copies one element past a 16-byte boundary, where ``this`` runs the
  wrapper's route (``ops.flash_attention``: three ``flash_realign``
  copies into aligned scratch, then ``flash_wide``, counted; built by
  ``_build`` from this checkout's sources) and every other build its C
  entry point (the parent's ``flash_wide_general``, -3 and -2; the code
  printed), held to ``this``'s output at each dtype's limit (2e-2, 5e-3,
  2e-5) and timed the same way (each side one call: the route's into a
  fresh output, an entry point's into one output made once; the route's
  ``flash_wide`` is the same source and flags as ``this.so``'s); beside
  them the copy alone (``ops.pad8`` on one of those inputs) and its byte
  bound;
- the cluster route past d = 576 at ``CLUSTER_SHAPES``, (4, 1024, 640),
  (16, 4096, 1024), (8, 4096, 2048) and (16, 4096, 1152) causal, at
  bfloat16, float16 and float32 on aligned inputs: ``this``'s
  ``flash_wide_cluster`` (return code -4 at 16 bits, -3 at float32) and
  every other build's C entry point on the same inputs (the parent's
  ``flash_wide_general``, -3 and -2; the code printed), held to
  ``this``'s output at each dtype's limit and timed in turns, SDPA
  (``is_causal``) timed once beside them;
- ``flash_f32`` (return code 0 at float32) at (16, 2048, d) causal: d =
  128 (``chip_smoke.py``'s float32 check), and d = 256 with softcap 50
  and q 8x larger (held at 1e-4: a build that sums a row on the tensor
  cores is about 5e-5 off float64 there), timed the same way;
- float32 accuracy at large logits: (2, 1024, d)
  causal with softcap 50 at d = 128, 256 (``flash_f32``) and 576
  (``flash_wide``), q drawn 1x and 8x larger (logits of order 1, and up
  to about 40), ``this``'s kernel through ``ops.flash_attention`` and
  the plain version (the wrapper on CPU tensors, float32) each against
  the same function computed in float64: max |error| and relative L2.

Times are device times per call (CUDA events over 20 calls queued
behind a sleep kernel), taken in turns: the builds in order, then in
reverse (parent, this, this, parent).  The last line is one JSON object
with every number; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import time

import torch

from .. import _build, _compare
from . import ops

_HERE = pathlib.Path(__file__).resolve().parent
OUT_DIR = _build.BUILD_DIR.parent / "flash_compare"
FN = "repro_flash_attn_bf16"
FN32 = "repro_flash_attn_f32"
FN16 = "repro_flash_attn_f16"
ENTRY = {torch.bfloat16: FN, torch.float32: FN32, torch.float16: FN16}
S = 8192
#: (name, heads, KV heads, head dim, window, softcap), as chip_smoke.py's
SHAPES = [("gemma2-9b local", 16, 8, 256, 4096, 50.0),
          ("gemma2-9b global", 16, 8, 256, 0, 50.0),
          ("qwen3-0.6b", 16, 8, 128, 0, 0.0)]
TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
#: the cluster route's shapes (BH, S, d), causal: chip_smoke.py's, then
#: clusters of 4 blocks (d 2048) and of 3 (d 1152)
CLUSTER_SHAPES = [(4, 1024, 640), (16, 4096, 1024), (8, 4096, 2048),
                  (16, 4096, 1152)]


def inputs(cuda: torch.device) -> dict:
    """Folded (BH, S, d) bf16 q, k, v of each shape from seed 0: q of
    standard deviation 8 where there is a softcap, k and v drawn for the
    KV heads and repeated."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    out = {}
    for name, H, Hkv, d, _, softcap in SHAPES:
        q = torch.randn((1, S, H, d), generator=gen, device=cuda)
        q = (q * (8.0 if softcap else 1.0)).to(torch.bfloat16)
        k, v = (torch.randn((1, S, Hkv, d), generator=gen, device=cuda)
                .to(torch.bfloat16).repeat_interleave(H // Hkv, dim=2)
                for _ in range(2))
        out[name] = tuple(x.transpose(1, 2).reshape(H, S, d).contiguous()
                          for x in (q, k, v))
    return out


def call(lib, q, k, v, o, window: int, softcap: float) -> int:
    BH, Sq, d = q.shape
    return getattr(lib, ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, Sq,
        k.shape[1], d, 1, window, ctypes.c_float(softcap),
        ctypes.c_float(d ** -0.5), torch.cuda.current_stream().cuda_stream)


def accuracy(cuda: torch.device) -> dict:
    """float32 against float64 at logits of order 1 and near 40."""
    from . import ops, ref

    out = {}
    for d in (128, 256, 576):
        for scale in (1.0, 8.0):
            gen = torch.Generator(device=cuda)
            gen.manual_seed(d)
            q, k, v = (torch.randn((2, 1024, d), generator=gen, device=cuda)
                       for _ in range(3))
            q = q * scale
            kw = dict(causal=True, window=0, softcap=50.0)
            want = ref.attention_f64(q, k, v, **kw)
            got = {"kernel": ops.flash_attention(q, k, v, **kw),
                   "plain": ops.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                                **kw).to(cuda)}
            row = {}
            for name, x in got.items():
                diff = x.double() - want
                row[name] = (float(diff.abs().max()),
                             float(diff.norm() / want.norm()))
            out[f"d {d} q x{scale:g}"] = row
            print(f"float32 (2, 1024, {d}) causal softcap 50, q x{scale:g}: "
                  + "; ".join(f"{n} vs float64 max {e:.3g}, relative L2 "
                              f"{r:.3g}" for n, (e, r) in row.items()),
                  flush=True)
    return out


_S = "          hop::wgmma_ss<T>(sc, hop::desc(qs + (s0 + j) * BOX"
_PV = "      switch (nch) {"
_LOAD = """      hop::mbar_expect_tx(full0 + 8 * at.s, BOX);
      hop::tma_load(ring + at.s * BOX, map, 64 * c, (kb + i) * BK, bh,
                    full0 + 8 * at.s);"""
_X = """      if (dl.C == 2)
        exchange_pair(dl.rank, sc, base, gbase, wg, tid, i);
      else
        exchange(dl, sc, base, gbase, wg, tid, i);"""
_CPV = """      if (nch == 2)
        values<T, 2>(o, pa, vs);
      else if (nch == 3)
        values<T, 3>(o, pa, vs);
      else
        values<T, 4>(o, pa, vs);"""
#: diagnostic copies of flash.cu (timed only): name -> (the namespace of
#: the kernel edited, its (text, replacement) pairs); ``p.BH < 0`` never
#: holds, so the guarded work is left out
BREAKDOWN = {
    "no_s": ("hw", [(_S, _S.replace("hop::", "if (p.BH < 0) hop::", 1))]),
    "no_pv": ("hw", [(_PV, "      if (p.BH < 0) switch (nch) {")]),
    "no_math": ("hw", [(_S, _S.replace("hop::", "if (p.BH < 0) hop::", 1)),
                       (_PV, "      if (p.BH < 0) switch (nch) {")]),
    "no_load": ("hw", [(_LOAD, "      hop::mbar_arrive(full0 + 8 * at.s);")]),
    "cluster_no_exchange": ("hc", [(_X, "      if (p.BH < 0) {\n" + _X
                                    + "\n      }")]),
    "cluster_no_math": ("hc", [
        (_S, _S.replace("hop::", "if (p.BH < 0) hop::", 1)),
        (_CPV, "      if (p.BH < 0) {\n" + _CPV + "\n      }")]),
}


def breakdown(out_dir: pathlib.Path) -> dict:
    """Write ``BREAKDOWN``'s copies of this checkout's flash.cu under
    ``out_dir``, each edit made once inside its kernel's namespace;
    returns name -> path."""
    src = (_HERE / "flash.cu").read_text()
    paths = {}
    for name, (ns, edits) in BREAKDOWN.items():
        start = src.index(f"namespace {ns} {{")
        end = src.index(f"}}  // namespace {ns}")
        body = src[start:end]
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"breakdown {name}: flash.cu's {ns} no "
                                   f"longer holds {old.strip()[:40]!r} once")
            body = body.replace(old, new)
        out_dir.mkdir(parents=True, exist_ok=True)
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(src[:start] + body + src[end:])
    return paths


def _kernel_name(name: str) -> str:
    """A kernel's name without its namespace and signature, its 16-bit
    element type as ``bf16`` or ``f16``."""
    name = re.sub(r"\b(hop|f32|wide|hw|fw|hc|fc)::", "", name)
    name = name.replace("__nv_bfloat16", "bf16").replace("__half", "f16")
    return name.split("(")[0].removeprefix("void ")


#: the wrapper's route on unaligned wide inputs: ``this`` runs
#: ``ops.flash_attention``, the other builds their C entry point
REALIGNED = "realigned"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: CUDA is not available; this script runs on the "
              "card only")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"this": _HERE / "flash.cu"}
    for spec in args.build:
        name, path = spec.split("=", 1)
        builds[name] = pathlib.Path(path)
    if args.breakdown:
        builds.update(breakdown(OUT_DIR / "src"))
    card = _compare.card()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs, ptxas = _compare.build(builds, OUT_DIR, (FN, FN32, FN16))
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, lines in ptxas.items():
        print(f"ptxas {name}: " + " | ".join(lines), flush=True)
    record = {"card": card, "reps": _compare.REPS, "ptxas": ptxas,
              "sass_equal": {}, "ms": {}, "max_abs_err": {}, "ret": {},
              "sdpa_ms": {}}

    this = _compare.sass(OUT_DIR / "this.so", _kernel_name)
    for name in [n for n in libs if n != "this"]:
        other = _compare.sass(OUT_DIR / f"{name}.so", _kernel_name)
        for key in sorted(set(this) | set(other)):
            same = key in this and this.get(key) == other.get(key)
            record["sass_equal"][f"{name} {key}"] = same
            print(f"{key} SASS: {name} {'=' if same else '!='} this "
                  f"({len(other.get(key, []))} and "
                  f"{len(this.get(key, []))} instructions)", flush=True)

    cuda = torch.device("cuda")
    data = inputs(cuda)
    cases = []
    for shape, *_, window, softcap in SHAPES:
        q, k, v = data[shape]
        cases += [(shape, "flash", 0, (q, k, v), window, softcap, TOL),
                  (shape, "flash_general", -1,
                   tuple(_compare.unaligned(x) for x in (q, k, v)), window, softcap,
                   TOL)]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for dt, code, tol in ((torch.bfloat16, -2, TOL),
                          (torch.float16, -2, 5e-3),
                          (torch.float32, -1, 2e-5)):
        xs = tuple(torch.randn((16, 4096, 576), generator=gen,
                               device=cuda).to(dt) for _ in range(3))
        name = f"deepseek-v2 absorbed {str(dt)[6:]}"
        cases += [(name, "flash_wide", code, xs, 0, 0.0, tol),
                  (name, REALIGNED, code - 1,
                   tuple(_compare.unaligned(x) for x in xs), 0, 0.0, tol)]
    for dt, code, tol in ((torch.bfloat16, -4, TOL),
                          (torch.float16, -4, 5e-3),
                          (torch.float32, -3, 2e-5)):
        for shape in CLUSTER_SHAPES:
            xs = tuple(torch.randn(shape, generator=gen, device=cuda).to(dt)
                       for _ in range(3))
            cases.append((f"d {shape[2]} {str(dt)[6:]}",
                          "flash_wide_cluster", code, xs, 0, 0.0, tol))
    # float32 up to d = 256: chip_smoke.py's check, and Gemma-2's width
    # and softcap with q 8x larger, where a build that sums each row on
    # the tensor cores is about 5e-5 off float64 (so 1e-4 between builds)
    for d, softcap, scale, tol in ((128, 0.0, 1.0, 2e-5),
                                   (256, 50.0, 8.0, 1e-4)):
        q, k, v = (torch.randn((16, 2048, d), generator=gen, device=cuda)
                   for _ in range(3))
        cases.append((f"float32 d {d} softcap {softcap:g} q x{scale:g}",
                      "flash_f32", 0, (q * scale, k, v), 0, softcap, tol))
    record["realign"] = {}
    for shape, route, code, xs, window, softcap, tol in cases:
        o = torch.empty_like(xs[0])
        want = None

        def run(name, lib, o=o, xs=xs, window=window, softcap=softcap,
                route=route):
            # the wrapper's route returns a fresh output, timed as it is;
            # a C entry point writes into o
            if name == "this" and route == REALIGNED:
                return ops.flash_attention(*xs, causal=True, window=window,
                                           softcap=softcap)
            return call(lib, *xs, o, window, softcap)

        for name, lib in libs.items():
            o.zero_()
            if name == "this" and route == REALIGNED:
                _build.launches.clear()
                o.copy_(run(name, lib))   # held once, outside the timing
                torch.cuda.synchronize()
                ret = dict(_build.launches)
                if ret != {"flash_realign": 3, "flash_wide": 1}:
                    raise RuntimeError(f"this {shape} {route}: launches "
                                       f"{ret}")
            else:
                ret = run(name, lib)
                torch.cuda.synchronize()
                # this build takes the case's route; an older one may
                # choose among other kernels, but must launch one
                if ret != code if name == "this" else ret > 0:
                    raise RuntimeError(f"{name} {shape} {route}: returned "
                                       f"{ret}, not {code}")
            record["ret"][f"{name} {shape} {route}"] = ret
            if name in BREAKDOWN:
                record["max_abs_err"][f"{name} {shape} {route}"] = None
                continue
            if not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"{name} {shape} {route}: output "
                                   f"not finite")
            if want is None:   # this build's
                want = o.float()
            err = float((o.float() - want).abs().max())
            if not torch.allclose(o.float(), want, rtol=tol, atol=tol):
                raise RuntimeError(f"{name} {shape} {route}: {err:.3g} "
                                   f"off this build's output")
            record["max_abs_err"][f"{name} {shape} {route}"] = err
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(_compare.device_ms(
                lambda name=name: run(name, libs[name])))
        record["ms"][f"{shape} {route}"] = times
        if route == "flash_wide_cluster":   # the library yardstick
            q4, k4, v4 = (x[None] for x in xs)
            t = _compare.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True))
            record["sdpa_ms"][shape] = t
            print(f"{shape} SDPA (is_causal) {tuple(xs[0].shape)}: {t:.4f} "
                  f"ms", flush=True)
        if route == REALIGNED:   # the copy alone: one tensor's bytes
            x = xs[0]
            nbytes = x.numel() * x.element_size() + \
                ops.pad8(x).numel() * x.element_size()
            ts = [_compare.device_ms(lambda: ops.pad8(x)) for _ in range(2)]
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            record["realign"][shape] = {"ms": ts, "bound_ms": bound,
                                        "bytes": nbytes}
            print(f"{shape} flash_realign alone {tuple(x.shape)} (base "
                  f"{x.data_ptr() % 16} bytes past 16): "
                  + ", ".join(f"{t:.4f}" for t in ts) + f" ms, bound "
                  f"{bound:.4f} ms ({nbytes} bytes over 3.35 TB/s; "
                  f"{bound / min(ts):.1%} of it)", flush=True)
        for name, ts in times.items():
            err = record["max_abs_err"][f"{name} {shape} {route}"]
            print(f"{shape} {route} {tuple(xs[0].shape)} "
                  f"{str(xs[0].dtype)[6:]}: {name} (returned "
                  f"{record['ret'][f'{name} {shape} {route}']}) "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms, "
                  + ("timed only" if err is None
                     else f"max |{name} - this| {err:.3g}"), flush=True)
    record["accuracy"] = accuracy(cuda)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
