#!/usr/bin/env python3
"""Drive the port's frame planners (``repro_torch``) end to end on one card.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each raising on failure: build the CUDA kernels from the sources
in the checkout; make T=64 frames of 512x512 (refinement bursts and the
paper's PIC series); hold every kernel against its plain PyTorch version
on the card; drive the 2D main path (``planner.plan_stream``, heuristic
and ``exact=True``, then plan pricing and executed migration) with the
kernels' launch counts set to zero just before it and read just after;
time the path and the kernels (K1 also at ``plan_iter``'s 16-frame
slices; the card's launch floor, one one-element ``add_``, beside K2 and
K3; K2's greedy steps; K3 also on a stream's 64 plans in one launch
beside its bound; K1, K2 and K3 by kernel).  Then the float64 plan path
(``run_f64``): K1 in float64 on the PIC frames held to its plain version
and the exact prefix (max_abs_err 0) and timed beside its bound and
``torch.cumsum``, then ``planner.plan_host(gamma_dtype=float64)`` with its
own launch counts, held to the CPU path and to the exact int64 bottleneck
of its plans.  Then the rebalance runtime (``run_runtime``):
``runtime.compare_policies`` over both streams with five policies, each
ledger held to the CPU path's, and ``run_stream`` under both fault
scenarios with migrations executed (executed bytes = priced volume,
forced replans at failures, no cell on a dead part), with its own launch
counts.  Then the serve simulator (``run_serve``, host NumPy).  Then the
same for the 3D path: T=16 volumes of 128^3 (the 3D PIC series and AMR
refinement), kernel K4 against its plain version, ``planner.plan_stream``
on rank-4 frames at m=1024 (a 16 x 8 x 8 processor grid) with its own launch
counts (every launch through K4's ``sat3`` route, none through
``sat3_general``), its checks and times (K4 also at B=1); then K4's
general route on purpose, planes too wide for one block, with its own
launch counts, held against the plain version.  Then float64 on the 3D
path (``run_f64_3d``): K4 in float64 held to its plain version and the
exact int64 prefix at every 8-byte plane class's edges and on the general
route, ``planner.plan_stream(gamma_dtype=float64)`` on both 3D streams with
its own launch counts, held to the CPU path bit for bit, its plans'
Lmax / (total/m) on the exact prefix beside float32's, and K4 float64
timed beside its bound and ``torch.cumsum``.  Then the sharded planner on
one card (``run_mesh``): ``dist.ctx.planner_mesh(devices=[cuda] * D)``,
the 2D heuristic at D = 1, 2, 4 and at a ragged T, the exact path and
the 3D path ragged, each bit-identical to the single-device plans, and
``run_stream`` sharded over two entries with migrations executed over
three, its ledger equal to the single-device run's, with its own launch
counts and each call's wall time beside the single-device call's.  Then
``dist.cp_balance`` and ``dist.moe_placement`` on the host (``run_dist``).
Then the paper's
algorithm registry (``core.registry``) with its own launch counts: its
device names at the paper's width (``jag-pq-opt-device`` at 512x512,
m=1024, on int32, float32 and ``speeds=`` with dead parts;
``jag-m-opt-device`` at 64x64, m=24; ``sgorp-2d``; ``explain``) and the
exact 1D solver on rows of 4,096 and 1,048,576 entries (the second
through K2's general route, ``probe_general``), each held against the
CPU path and the host engine, and K2 against its plain version at every
shape the phase gave it.  The last two lines
before the final one are the kernels' JSON record and the card's name
and power limit; the final line is ``{"ok": true, "device": {...}}``.
Last, flash attention (K5):
``kernels.flash.ops.attention`` at full model width, B=1 and S=8192 in
bf16 — Gemma-2-9B's local (window 4096) and global layers (16 heads, its
8 KV heads through ``models.layers.repeat_kv``, head dim 256, softcap 50)
and Qwen3-0.6B's (16 heads from 8 KV heads, head dim 128) — with its own
launch counts, each output held against the plain version on the card
(rtol = atol = 2e-2, as ``tests/test_flash.py``, and a relative L2 error
of at most 1e-2), every shape through the Hopper kernel (launch key
``flash``, none through ``flash_mma``).  Then the general bf16 route with
its own launch counts: the same inputs, folded to ``(BH, S, d)`` and
copied one element past a 16-byte boundary, which TMA cannot describe,
through ``kernels.flash.ops.flash_attention`` (every shape through
``flash_mma``, none through ``flash``), held to the same limits.  Last one
float32 check at Qwen3 width and S=2048 (2e-5).  The Gemma-2 queries are drawn large enough that
the softcap changes the logits; ``flex_attention`` (compiled) is timed
there as the library yardstick, SDPA at Qwen3 and SDPA on float32 beside
the float32 check.

Dtype contract checked here: int32 results are bit-identical between the
kernels and the plain versions, and to the CPU path; so are float32
results where every frame total is below 2**24.  Above it (the PIC
series reaches 5.2e8) float32 sums may be taken in another order: Gamma
is held to 1e-6 of the frame total against the exact int64 prefix, Lmax
to a relative 1e-2 against the CPU path, and the cuts may differ.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

T, N1, N2, M, P = 64, 512, 512, 1024, 32
T3, N3, M3 = 16, 128, 1024           # the 3D path: 16 volumes of 128^3
Q = M // P
F32_EXACT = 2 ** 24
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
FP64_OPS_PER_S = 34e12      # H100 SXM float64 rate outside the tensor cores
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def log(tag: str, msg: str) -> None:
    print(f"[{tag} +{time.perf_counter() - _T0:.0f}s] {msg}", flush=True)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (ms): the card is held by a sleep
    kernel while ``reps`` calls are enqueued behind it, so the CUDA events
    time the device work and not the host's enqueue."""
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


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def by_kernel(fn, reps: int = 10) -> str:
    """Device time per launch of each CUDA kernel that ``fn`` launches
    (torch.profiler over ``reps`` calls; the profiler may miss the first
    launches of its window, so each time is over its own count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return "; ".join(
        f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')}"
        .split("(")[0] + f" {e.self_device_time_total / e.count / 1e3:.4f} "
        f"ms ({e.count} of {reps} launches seen)" for e in ev)


def copy_rate(a: torch.Tensor) -> str:
    """The card's practical rate for the same bytes: one device copy of
    ``a`` (its bytes read once and written once)."""
    b = torch.empty_like(a)
    ms = device_ms(lambda: b.copy_(a))
    return (f"a device copy of the input ({2 * a.numel() * 4} bytes) "
            f"{ms:.4f} ms, {2 * a.numel() * 4 / ms / 1e9:.2f} TB/s")


def touched_entries(row_cuts: np.ndarray, col_cuts: np.ndarray) -> int:
    """Distinct Gamma entries one plan's rectangle loads need: the two row
    cuts of each stripe at each of its column cuts."""
    r = row_cuts.astype(np.int64)
    c = col_cuts.astype(np.int64)
    return np.unique(np.concatenate([(r[:-1, None] * (N2 + 1) + c).ravel(),
                                     (r[1:, None] * (N2 + 1) + c).ravel()
                                     ])).size


def run_rectload_stream(cuda: torch.device, plans: list, gammas: list,
                        floor_ms: float) -> None:
    """K3 at the shape its frame axis exists for: a stream's T plans of
    (P + 1) row cuts and (P, m - P + 2) padded column cuts in one launch,
    on their float32 Gammas, held to the plain version bit for bit and
    timed beside its bound (counted as the one-plan entry counts it)."""
    from repro_torch.kernels.rectload import ops as rl_ops
    from repro_torch.kernels.rectload import ref as rl_ref

    g = torch.from_numpy(np.stack(gammas).astype(np.float32)).to(cuda)
    rc = torch.as_tensor(np.stack([pl.row_cuts for pl in plans]),
                         device=cuda).int()
    cc_np = np.stack([pl._live_col_cuts() for pl in plans])
    cc = torch.as_tensor(cc_np, device=cuda).int()
    got = rl_ops.jagged_loads(g, rc, cc)
    check(torch.equal(got, rl_ref.jagged_loads_ref(g, rc, cc).float()),
          f"rectload {tuple(cc.shape)}: kernel differs from the plain "
          f"version")
    touched = sum(touched_entries(pl.row_cuts, c)
                  for pl, c in zip(plans, cc_np))
    n_rect = got.numel()
    nbytes = touched * 4 + rc.numel() * 4 + cc.numel() * 4 + n_rect * 4
    b_ms, _ = bound(nbytes, 3 * n_rect)
    ms = device_ms(lambda: rl_ops.jagged_loads(g, rc, cc))
    plain_ms = device_ms(lambda: rl_ref.jagged_loads_ref(g, rc, cc).float())
    log("rectload", f"K3 on a stream's {len(plans)} plans in one launch: "
        f"Gamma {tuple(g.shape)} float32, cuts {tuple(rc.shape)} / "
        f"{tuple(cc.shape)}; bit-identical to the "
        f"plain version; {ms:.4f} ms against a bound of {b_ms:.4f} ms "
        f"({ms / b_ms:.2f}x; {nbytes} bytes: {touched} distinct Gamma "
        f"entries, the cuts, {n_rect} loads), "
        f"{ms - floor_ms:.4f} ms above the launch floor; plain version "
        f"{plain_ms:.4f} ms; by kernel: "
        f"{by_kernel(lambda: rl_ops.jagged_loads(g, rc, cc))}")


def volumes() -> tuple[dict, dict, dict]:
    """The 3D paths' data: T3 volumes of N3^3 of each 3D stream, their
    exact int64 Gamma3s and frame totals."""
    from repro_torch.core import prefix
    from repro_torch.rebalance import stream

    # -- 8. data -----------------------------------------------------------
    t0 = time.perf_counter()
    vols = {name: stream.STREAMS_3D[name](T3, N3, N3, N3, seed=SEED)
            for name in ("pic3d", "amr3d")}
    g3 = {k: [prefix.prefix_sum_3d(f) for f in v] for k, v in vols.items()}
    tot3 = {k: np.array([g[-1, -1, -1] for g in v]) for k, v in g3.items()}
    log("data3", f"T={T3} {N3}^3 volumes made in "
        f"{time.perf_counter() - t0:.1f} s; frame totals: " + ", ".join(
            f"{k} {int(v.min())}..{int(v.max())}" for k, v in tot3.items()))
    return vols, g3, tot3


def run_3d(cuda: torch.device, vols: dict, g3: dict,
           tot3: dict) -> tuple[list, dict]:
    """The 3D path: K4 against its plain version, the main path through
    ``planner.plan_stream`` on rank-4 frames with its own launch counts,
    its checks and times, then K4's general route on purpose.  Returns K4's
    two entries of the kernels' record (``sat3``, ``sat3_general``) and
    the float32 plans' Lmax / (total/m) on the exact prefix by stream."""
    from repro_torch.core import sgorp, threed
    from repro_torch.kernels import _build
    from repro_torch.kernels.sat import ops as sat_ops
    from repro_torch.kernels.sat import ref as sat_ref
    from repro_torch.rebalance import planner, stream

    grid = sgorp.default_grid(M3, (N3, N3, N3))

    # -- 9. K4 against its plain version on the card ----------------------
    rng = np.random.default_rng(SEED)
    for shape in ((1, 1, 1), (5, 7, 9), (3, 17, 33, 130), (2, 0, 4, 5),
                  (T3, N3, N3, N3)):
        high = 8 if shape == (T3, N3, N3, N3) else 100   # totals < 2**24
        a64 = torch.as_tensor(rng.integers(0, high, shape), device=cuda)
        for dt in (torch.int32, torch.float32):
            a = a64.to(dt)
            check(torch.equal(sat_ops.gamma3(a), sat_ref.gamma3_ref(a)),
                  f"sat3 {shape} {dt}: kernel differs from the plain "
                  f"version")
    log("sat3", "odd shapes (1,1,1), (5,7,9), (3,17,33,130), (2,0,4,5) and "
        f"the path's ({T3},{N3},{N3},{N3}), random integer loads with frame "
        f"totals below 2**24, int32 and float32: bit-identical to the plain "
        f"version")
    err = 0.0
    for name, fr in vols.items():
        a64 = torch.as_tensor(fr, device=cuda)
        g_exact = torch.as_tensor(np.stack(g3[name]), device=cuda)
        ai = a64.to(torch.int32)
        check(torch.equal(sat_ops.gamma3(ai), sat_ref.gamma3_ref(ai)),
              f"sat3 {name} int32: kernel differs from the plain version")
        af = a64.to(torch.float32)
        gk, gp = sat_ops.gamma3(af), sat_ref.gamma3_ref(af)
        err = max(err, float((gk.double() - gp.double()).abs().max()))
        tot = torch.as_tensor(tot3[name], device=cuda,
                              dtype=torch.float64)[:, None, None, None]
        rk = float(((gk.double() - g_exact.double()).abs() / tot).max())
        rp = float(((gp.double() - g_exact.double()).abs() / tot).max())
        check(rk <= 1e-6, f"sat3 {name} float32: kernel is {rk:.3g} x the "
              f"frame total off the exact prefix (limit 1e-6)")
        log("sat3", f"{name}: int32 bit-identical to the plain version; "
            f"float32 (frame totals up to {tot3[name].max():.3e}; float32 "
            f"is exact below 2**24) kernel vs the exact int64 prefix "
            f"{rk:.3g} x frame total (limit 1e-6), plain cumsum vs exact "
            f"{rp:.3g}")
        del a64, g_exact, gk, gp, ai, af

    # -- 10. the 3D main path ---------------------------------------------
    _build.launches.clear()
    out3 = {}
    for name, fr in vols.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = planner.plan_stream(fr, P=0, m=M3)
        out3[name] = tuple(x.cpu() for x in out)
        log("plan3", f"{name}: T={T3} planned in "
            f"{time.perf_counter() - t0:.2f} s (host clock, first call)")
    launches = dict(_build.launches)
    log("main3", f"kernel launches on the 3D path: {launches}")
    check(launches.get("sat3", 0) >= 1, "kernel sat3 never ran on the 3D "
          "path")
    check(launches.get("sat3_general", 0) == 0, "the 3D path took K4's "
          "general route (sat3_general)")

    for name, fr in vols.items():
        c1, c2, c3, L, it, pr = out3[name]
        ratios = []
        for t in range(T3):
            part = threed.partition3d_from_grid(c1[t], c2[t], c3[t],
                                                shape=(N3, N3, N3))
            check(part.is_valid() and len(part.boxes) == M3,
                  f"{name} frame {t}: cuts are not a valid {M3}-box "
                  f"partition")
            ratios.append(part.max_load(fr[t], gamma3=g3[name][t])
                          / (tot3[name][t] / M3))
        ratios = np.array(ratios)
        g = sat_ops.gamma3(torch.as_tensor(fr, device=cuda).float())
        warm = sgorp.warm_start_impl(g, grid=grid)
        _, warm_L, _, _ = sgorp.sgorp_refine_impl(g, warm, grid=grid,
                                                  max_iters=1)
        warm_L = warm_L.cpu()
        check(bool((L <= warm_L).all()), f"{name}: refined Lmax above the "
              f"warm start's")
        log("plan3", f"{name}: all {T3} plans valid Partition3D of {M3} "
            f"boxes, grid {grid}; Lmax / (total/m) on the exact int64 "
            f"prefix from {ratios.min():.4f} to {ratios.max():.4f} (mean "
            f"{ratios.mean():.4f}); refined Lmax <= warm start on every "
            f"frame (mean gain {float((1 - L / warm_L).mean()):.4f}); SGORP "
            f"iterations {it.tolist()}, projections {pr.tolist()}")
        out3[name] = out3[name] + (ratios,)

    # card = CPU: int32 Gamma3 on 4 frames of each stream
    for name, fr in vols.items():
        got = planner.plan_stream(fr[:4], P=0, m=M3, gamma_dtype=torch.int32)
        want = planner.plan_stream(fr[:4], P=0, m=M3,
                                   gamma_dtype=torch.int32, device="cpu")
        same = [torch.equal(a.cpu(), b) for a, b in zip(got, want)]
        check(all(same), f"{name} int32: card and CPU differ on 4 frames "
              f"(cuts1-3, Lmax, iters, projections: {same})")
    log("plan3", f"int32 Gamma3, 4 frames of each stream at {N3}^3: card "
        f"= CPU bit for bit (cuts, Lmax, iterations, projections)")
    # card = CPU: float32 default, amr3d at 64^3 (totals below 2**24)
    small = stream.amr_series_3d(T3, 64, 64, 64, seed=SEED)
    check(int(small.reshape(T3, -1).sum(1).max()) < F32_EXACT,
          "amr3d 64^3 frame totals must stay below 2**24")
    got = planner.plan_stream(small, P=0, m=M3)
    want = planner.plan_stream(small, P=0, m=M3, device="cpu")
    same = [torch.equal(a.cpu(), b) for a, b in zip(got, want)]
    check(all(same), f"amr3d 64^3 float32: card and CPU differ ({same})")
    log("plan3", f"float32 Gamma3, amr3d T={T3} at 64^3 (frame totals up "
        f"to {int(small.reshape(T3, -1).sum(1).max())}, below 2**24): card "
        f"= CPU bit for bit")
    # float32 at the path's size (totals above 2**24): Lmax within 1e-2
    # of the CPU path
    for name, fr in vols.items():
        cpu = planner.plan_stream(fr, P=0, m=M3, device="cpu")
        dl = float(((out3[name][3].double() - cpu[3].double()).abs()
                    / cpu[3].double()).max())
        cpu_ratio = np.mean([threed.partition3d_from_grid(
            cpu[0][t], cpu[1][t], cpu[2][t], shape=(N3, N3, N3)).max_load(
                fr[t], gamma3=g3[name][t]) / (tot3[name][t] / M3)
            for t in range(T3)])
        card_ratio = float(out3[name][6].mean())
        check(abs(card_ratio - cpu_ratio) <= 1e-2, f"{name} float32: mean "
              f"Lmax/(total/m) {card_ratio:.4f} on the card vs "
              f"{cpu_ratio:.4f} on the CPU (limit 1e-2)")
        same = all(torch.equal(a, b) for a, b in zip(out3[name][:3],
                                                     cpu[:3]))
        log("plan3", f"{name} float32 at {N3}^3 vs the CPU path: largest "
            f"per-frame |dLmax|/Lmax {dl:.3g}; mean Lmax/(total/m) card "
            f"{card_ratio:.6f}, CPU {cpu_ratio:.6f} (limit 1e-2); cuts "
            f"{'equal' if same else 'differ'} (frame totals up to "
            f"{tot3[name].max():.3e})")

    # -- 11. times ---------------------------------------------------------
    for name, fr in vols.items():
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            [c.cpu() for c in planner.plan_stream(fr, P=0, m=M3)]
            runs.append((time.perf_counter() - t0) * 1e3)
        runs = runs[1:]
        med = statistics.median(runs)
        log("e2e3", f"plan_stream {name} T={T3} {N3}^3 m={M3}, cuts copied "
            f"to the host: median {med:.1f} ms over 5 runs (min "
            f"{min(runs):.1f}, max {max(runs):.1f}); {T3 / med * 1e3:.1f} "
            f"frames/s; {int(out3[name][4].max())} loop iterations (one "
            f"flag read each)")
    fr = vols["pic3d"]
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    up = stage("upload", lambda: torch.as_tensor(fr, device=cuda))
    ing = stage("ingest", lambda: planner.ingest_stage(up))
    g = stage("sat3", lambda: sat_ops.gamma3(ing))
    warm = stage("warm", lambda: sgorp.warm_start_impl(g, grid=grid))
    res = stage("refine", lambda: sgorp.sgorp_refine_impl(g, warm,
                                                          grid=grid))
    stage("collect", lambda: [c.cpu() for c in res[0]])
    log("e2e3", "stages, pic3d: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in stages.items()))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        [c.cpu() for c in planner.plan_stream(fr, P=0, m=M3)]
        wall = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:4]
    log("e2e3", f"profiler, plan_stream pic3d: "
        f"{sum(e.count for e in dev_ev)} device operations, device busy "
        f"{busy:.1f} ms of {wall:.1f} ms wall, idle share "
        f"{1 - busy / wall:.3f}; most time: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
            f"({e.count}x)" for e in top))

    # K4 at the path's shape: (16, 128, 128, 128) float32
    a = torch.as_tensor(fr, device=cuda).to(torch.float32)
    nbytes = a.numel() * 4 + T3 * (N3 + 1) ** 3 * 4
    b_ms, b_by = bound(nbytes, 3 * a.numel())
    log("kernels", f"sat3: shape {tuple(a.shape)} float32, {nbytes} bytes "
        f"in and out; library_ms is torch.cumsum three times")
    k4 = {
        "name": "sat3", "route": "cuda",
        "source": "src/repro_torch/kernels/sat/sat3d.cu",
        "replaces": "src/repro/kernels/sat/sat3d.py:83",
        "launches": launches.get("sat3", 0), "max_abs_err": err,
        "ms": device_ms(lambda: sat_ops.gamma3(a)),
        "plain_ms": device_ms(lambda: sat_ref.gamma3_ref(a)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.cumsum(torch.cumsum(
            torch.cumsum(a, dim=-3), dim=-2), dim=-1))}
    a1 = a[:1].contiguous()
    nb1 = a1.numel() * 4 + (N3 + 1) ** 3 * 4
    log("sat3", f"K4 at B=1, shape {tuple(a1.shape)} float32: "
        f"{device_ms(lambda: sat_ops.gamma3(a1)):.4f} ms against a bound of "
        f"{bound(nb1, 3 * a1.numel())[0]:.4f} ms ({nb1} bytes in and out); "
        f"at B={T3}: {k4['ms']:.4f} ms against {b_ms:.4f} ms")
    log("sat3", f"K4 at {tuple(a.shape)} float32 by kernel: "
        f"{by_kernel(lambda: sat_ops.gamma3(a))}; {copy_rate(a)}")
    del a, a1
    return [k4, run_sat3_general(cuda)], {k: v[6] for k, v in out3.items()}


SHAPE_G = (2, 128, 128, 300)   # n3 > 256: planes too wide for one block


def run_sat3_general(cuda: torch.device) -> dict:
    """K4's general route on purpose: a stack whose planes no block of the
    fast route holds, with its own launch counts, against the plain version
    (int32 and float32 below 2**24 bit for bit, float32 above it within
    1e-6 of the frame total).  Returns its entry of the kernels' record."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sat import ops as sat_ops
    from repro_torch.kernels.sat import ref as sat_ref

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    check(sat_ops.sat3_plan(*SHAPE_G, sms)[0] == "sat3_general",
          f"{SHAPE_G} should take K4's general route")
    rng = np.random.default_rng(SEED + 1)
    small = torch.as_tensor(rng.integers(0, 3, SHAPE_G), device=cuda)
    check(int(small.reshape(SHAPE_G[0], -1).sum(1).max()) < F32_EXACT,
          "sat3_general's small loads must keep frame totals below 2**24")
    large = torch.as_tensor(rng.integers(0, 4000, SHAPE_G), device=cuda)
    _build.launches.clear()
    for dt in (torch.int32, torch.float32):
        a = small.to(dt)
        check(torch.equal(sat_ops.gamma3(a), sat_ref.gamma3_ref(a)),
              f"sat3_general {SHAPE_G} {dt}: kernel differs from the plain "
              f"version")
    exact = torch.cumsum(torch.cumsum(torch.cumsum(large, -3), -2), -1)
    total = exact[:, -1, -1, -1].double()
    af = large.to(torch.float32)
    gk = sat_ops.gamma3(af)
    err = float((gk[:, 1:, 1:, 1:].double() - sat_ref.sat3_ref(af).double())
                .abs().max())
    rk = float(((gk[:, 1:, 1:, 1:].double() - exact.double()).abs()
                / total[:, None, None, None]).max())
    check(rk <= 1e-6, f"sat3_general float32: kernel is {rk:.3g} x the "
          f"frame total off the exact prefix (limit 1e-6)")
    glaunches = dict(_build.launches)
    check(glaunches.get("sat3_general", 0) == 3
          and glaunches.get("sat3", 0) == 0,
          f"K4's general step launched {glaunches}, not 3 sat3_general")
    nbytes = af.numel() * 4 + SHAPE_G[0] * math.prod(
        n + 1 for n in SHAPE_G[1:]) * 4
    b_ms, b_by = bound(nbytes, 3 * af.numel())
    log("sat3", f"general route (sat3_general) on purpose at {SHAPE_G}: "
        f"int32 and float32 below 2**24 bit-identical to the plain version; "
        f"float32 with frame totals up to {float(total.max()):.3e}: "
        f"{rk:.3g} x the frame total off the exact int64 prefix (limit "
        f"1e-6); launches {glaunches} (none on the 3D path)")
    return {
        "name": "sat3_general", "route": "cuda",
        "source": "src/repro_torch/kernels/sat/sat3d.cu",
        "replaces": "src/repro/kernels/sat/sat3d.py:83",
        "launches": glaunches.get("sat3_general", 0), "max_abs_err": err,
        "ms": device_ms(lambda: sat_ops.gamma3(af)),
        "plain_ms": device_ms(lambda: sat_ref.gamma3_ref(af)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.cumsum(torch.cumsum(
            torch.cumsum(af, dim=-3), dim=-2), dim=-1))}


#: K4 float64's edges: each 8-byte plane class's widest and tallest plane
#: and one entry past it (the general route), band edges, empty slabs and
#: planes, and the general route's shape
SHAPES_F64_3D = [(1, 1, 1), (5, 7, 9), (2, 0, 4, 5), (3, 6, 0, 2),
                 (16, 130, 17, 19), (1, 5, 512, 32), (1, 5, 513, 32),
                 (2, 9, 256, 64), (2, 9, 257, 64), (2, 3, 128, 128),
                 (2, 3, 129, 128), SHAPE_G]


def exact_gamma3(a64: torch.Tensor) -> torch.Tensor:
    """The exact exclusive 3D prefix of int64 loads (cumsum in int64)."""
    s = torch.cumsum(torch.cumsum(torch.cumsum(a64, -3), -2), -1)
    return torch.nn.functional.pad(s, [1, 0, 1, 0, 1, 0])


def run_f64_3d(cuda: torch.device, vols: dict, g3: dict, tot3: dict,
               ratio32: dict) -> dict:
    """float64 on the 3D path: K4 in float64 against its plain version and
    the exact int64 prefix at every 8-byte plane class's edges and on the
    general route, then ``planner.plan_stream(gamma_dtype=float64)`` on
    both 3D streams with its own launch counts, held to the CPU path bit
    for bit and to the float32 plans' quality on the exact prefix, and
    K4 float64 timed beside its bound and ``torch.cumsum``.  Returns K4
    float64's entry of the kernels' record."""
    from repro_torch.core import threed
    from repro_torch.kernels import _build
    from repro_torch.kernels.sat import ops as sat_ops
    from repro_torch.kernels.sat import ref as sat_ref
    from repro_torch.rebalance import planner

    # -- 12. K4 float64 against its plain version and the exact prefix ----
    rng = np.random.default_rng(SEED + 4)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    routes = []
    for shape in SHAPES_F64_3D:
        a64 = torch.as_tensor(rng.integers(0, 2 ** 30, shape), device=cuda)
        a = a64.double()
        got = sat_ops.gamma3(a)
        check(torch.equal(got, sat_ref.gamma3_ref(a))
              and torch.equal(got, exact_gamma3(a64).double()),
              f"sat3 float64 {shape}: kernel differs from the plain version "
              f"or the exact int64 prefix")
        b = shape if len(shape) == 4 else (1,) + shape
        route, c, _ = sat_ops.sat3_plan(*b, sms, 8)
        routes.append(f"{shape} {route}" + (f" class {c}" if c else ""))
    del a64, a, got
    log("sat3_f64", "K4 float64 on integer loads up to 2**30 (exact in "
        "float64), bit-identical to the plain version and the exact int64 "
        "prefix at: " + "; ".join(routes))
    err = 0.0
    for name, fr in vols.items():
        a = torch.as_tensor(fr, device=cuda).double()
        gk = sat_ops.gamma3(a)
        err = max(err, float((gk - sat_ref.gamma3_ref(a)).abs().max()))
        check(torch.equal(gk, torch.as_tensor(np.stack(g3[name]),
                                              device=cuda).double()),
              f"sat3 float64 {name}: kernel is not the exact int64 prefix")
        del a, gk
    check(err == 0, f"sat3 float64: kernel {err} off the plain version on "
          f"the path's volumes")
    log("sat3_f64", f"the path's volumes ({T3}, {N3}, {N3}, {N3}) of both "
        f"streams in float64 (frame totals up to "
        f"{max(int(v.max()) for v in tot3.values()):.3e}): bit-identical to "
        f"the plain version and the exact int64 prefix (max_abs_err 0)")

    # -- 13. the float64 3D path -------------------------------------------
    _build.launches.clear()
    out64 = {}
    for name, fr in vols.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = planner.plan_stream(fr, P=0, m=M3, gamma_dtype=torch.float64)
        out64[name] = tuple(x.cpu() for x in out)
        log("plan3_f64", f"{name}: T={T3} gamma_dtype=float64 planned in "
            f"{time.perf_counter() - t0:.2f} s (host clock, first call)")
    launches = dict(_build.launches)
    log("plan3_f64", f"kernel launches on the float64 3D path: {launches}")
    check(launches.get("sat3", 0) >= 1, "kernel sat3 never ran on the "
          "float64 3D path")
    check(launches.get("sat3_general", 0) == 0, "the float64 3D path took "
          "K4's general route (sat3_general)")
    for name, fr in vols.items():
        check(int(tot3[name].max()) < 2 ** 53, "float64 planning needs "
              "frame totals below 2**53")
        t0 = time.perf_counter()
        cpu = planner.plan_stream(fr, P=0, m=M3, gamma_dtype=torch.float64,
                                  device="cpu")
        cpu_s = time.perf_counter() - t0
        same = [torch.equal(a, b) for a, b in zip(out64[name], cpu)]
        check(all(same), f"{name} float64: card and CPU differ (cuts1-3, "
              f"Lmax, iters, projections: {same})")
        c1, c2, c3 = out64[name][:3]
        ratios = []
        for t in range(T3):
            part = threed.partition3d_from_grid(c1[t], c2[t], c3[t],
                                                shape=(N3, N3, N3))
            check(part.is_valid() and len(part.boxes) == M3,
                  f"{name} float64 frame {t}: cuts are not a valid "
                  f"{M3}-box partition")
            ratios.append(part.max_load(fr[t], gamma3=g3[name][t])
                          / (tot3[name][t] / M3))
        r64, r32 = np.array(ratios), ratio32[name]
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            [x.cpu() for x in planner.plan_stream(
                fr, P=0, m=M3, gamma_dtype=torch.float64)]
            runs.append((time.perf_counter() - t0) * 1e3)
        log("plan3_f64", f"{name} float64 at {N3}^3 (frame totals up to "
            f"{tot3[name].max():.3e}; float32 is exact below 2**24): card = "
            f"CPU bit for bit "
            f"(cuts, Lmax, iterations, projections; the CPU path took "
            f"{cpu_s:.2f} s); all {T3} plans valid; Lmax / (total/m) on the "
            f"exact int64 prefix float64 mean {r64.mean():.6f} (max "
            f"{r64.max():.6f}), float32 mean {r32.mean():.6f} (max "
            f"{r32.max():.6f}); plan_stream float64 host clock over 3 runs "
            f"median {statistics.median(runs):.1f} ms (min {min(runs):.1f}, "
            f"max {max(runs):.1f}); SGORP iterations "
            f"{out64[name][4].tolist()}")

    # -- 14. K4 float64 at the path's shape: (16, 128, 128, 128) -----------
    a = torch.as_tensor(vols["pic3d"], device=cuda).double()
    nbytes = a.numel() * 8 + T3 * (N3 + 1) ** 3 * 8
    b_ms, b_by = bound(nbytes, 3 * a.numel(), FP64_OPS_PER_S)
    k4 = {
        "name": "sat3_f64", "route": "cuda",
        "source": "src/repro_torch/kernels/sat/sat3d.cu",
        "replaces": "src/repro/kernels/sat/sat3d.py:83",
        "launches": launches.get("sat3", 0), "max_abs_err": err,
        "ms": device_ms(lambda: sat_ops.gamma3(a)),
        "plain_ms": device_ms(lambda: sat_ref.gamma3_ref(a)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.cumsum(torch.cumsum(
            torch.cumsum(a, dim=-3), dim=-2), dim=-1))}
    log("sat3_f64", f"K4 float64 at {tuple(a.shape)}: {k4['ms']:.4f} ms "
        f"against a bound of {b_ms:.4f} ms ({nbytes} bytes in and out, "
        f"{k4['ms'] / b_ms:.2f}x); plain version {k4['plain_ms']:.4f} ms, "
        f"torch.cumsum three times {k4['library_ms']:.4f} ms; by kernel: "
        f"{by_kernel(lambda: sat_ops.gamma3(a))}")
    del a
    return k4


def run_mesh(cuda: torch.device, streams: dict, totals: dict,
             vols: dict) -> None:
    """The sharded planner on one card: ``planner_mesh(devices=[cuda] *
    D)`` runs every shard on the card, so each sharded call must give the
    single-device plans bit for bit.  The 2D heuristic at D = 1, 2, 4 and
    at a ragged T, the exact path and the 3D path ragged, then
    ``run_stream`` sharded over two entries with migrations executed over
    three; each call's wall time beside the single-device call's."""
    from repro_torch.dist import ctx
    from repro_torch.kernels import _build
    from repro_torch.rebalance import planner, policy, runtime

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(a, b) -> bool:
        return all(x.device == y.device and torch.equal(x, y)
                   for x, y in zip(a, b))

    # -- 15. sharded plans = single-device plans ---------------------------
    rb = streams["refinement-bursts"]
    _build.launches.clear()
    single = {}
    for D, Tn in ((1, T), (2, T), (4, T), (4, T - 3)):
        mesh = ctx.planner_mesh(devices=[cuda] * D)
        if Tn not in single:
            single[Tn] = timed(lambda: planner.plan_stream(rb[:Tn], P=P,
                                                           m=M))
        got, s = timed(lambda: planner.plan_stream(rb[:Tn], P=P, m=M,
                                                   mesh=mesh))
        check(same(got, single[Tn][0]), f"mesh D={D} T={Tn} heuristic: "
              f"sharded plans differ from the single-device plans")
        log("mesh", f"heuristic refinement-bursts T={Tn} {N1}x{N2} m={M} "
            f"on [cuda] * {D}: bit-identical to one device (row_cuts, "
            f"counts, col_cuts, Lmax); {s:.2f} s against {single[Tn][1]:.2f} "
            f"s on one device (host clock)")
    fr = rb[:7]
    want, s1 = timed(lambda: planner.plan_stream(fr, P=P, m=M, exact=True))
    got, s = timed(lambda: planner.plan_stream(
        fr, P=P, m=M, exact=True, mesh=ctx.planner_mesh(devices=[cuda] * 2)))
    check(same(got, want), "mesh D=2 exact: sharded plans differ from the "
          "single-device plans")
    log("mesh", f"exact refinement-bursts T=7 (ragged) on [cuda] * 2: "
        f"bit-identical to one device; {s:.2f} s against {s1:.2f} s")
    v = vols["pic3d"][:T3 - 1]
    want, s1 = timed(lambda: planner.plan_stream_3d(v, m=M3))
    got, s = timed(lambda: planner.plan_stream_3d(
        v, m=M3, mesh=ctx.planner_mesh(devices=[cuda] * 2)))
    check(same(got, want), "mesh D=2 3D: sharded plans differ from the "
          "single-device plans")
    log("mesh", f"plan_stream_3d pic3d T={T3 - 1} (ragged) {N3}^3 m={M3} on "
        f"[cuda] * 2: bit-identical to one device (cuts, Lmax, iterations, "
        f"projections); {s:.2f} s against {s1:.2f} s")

    # -- 16. the runtime sharded, migrations over three entries -----------
    kw = dict(P=P, m=M, alpha=ALPHA,
              replan_overhead=float(totals["refinement-bursts"].mean()) / M,
              execute=True)
    one, s1 = timed(lambda: runtime.run_stream(rb, policy.EveryK(8), **kw))
    many, s = timed(lambda: runtime.run_stream(
        rb, policy.EveryK(8), devices=[cuda] * 2,
        execute_devices=[cuda] * 3, **kw))
    bad = ledger_diff(many, one)
    check(not bad, f"run_stream on [cuda] * 2, execute_devices [cuda] * 3: "
          f"ledger differs from one device: {bad[:5]}")
    replans = [r for r in many.records[1:] if r.replanned]
    check(replans and all(r.executed_bytes == r.migration_volume
                          for r in replans),
          "run_stream on several devices: executed bytes differ from the "
          "priced migration volume")
    launches = dict(_build.launches)
    for k in ("sat", "probe", "sat3", "rectload"):
        check(launches.get(k, 0) >= 1, f"kernel {k} never ran in the mesh "
              f"phase")
    log("mesh", f"run_stream refinement-bursts T={T} every-8 with execute on "
        f"devices=[cuda] * 2, execute_devices=[cuda] * 3: ledger = one "
        f"device's (every StepRecord field but wall_time, the final plan); "
        f"executed = priced on all {len(replans)} replans "
        f"({sum(r.executed_bytes for r in replans):.0f}); {s:.2f} s against "
        f"{s1:.2f} s on one device; launches over the phase {launches}")


def run_dist() -> None:
    """``dist.cp_balance`` and ``dist.moe_placement`` on the host (NumPy,
    nothing on the card) at the reference tests' sizes: the plans' validity
    and the properties those tests state, with host times."""
    from repro_torch.core import prefix
    from repro_torch.dist import cp_balance, moe_placement
    from repro_torch.rebalance import policy

    # -- 17. context-parallel block plans ---------------------------------
    t0 = time.perf_counter()
    nb, R = 64, 8
    base = cp_balance.balanced_plan(nb, R)
    check(np.array_equal(base, cp_balance.balanced_plan(
        nb, R, speeds=np.ones(R))), "cp: ones speeds change the plan")
    naive = cp_balance.plan_imbalance(cp_balance.contiguous_plan(nb, R), nb, R)
    bal = cp_balance.plan_imbalance(base, nb, R)
    zig = cp_balance.plan_imbalance(cp_balance.interleaved_assignment(nb, R),
                                    nb, R, contiguous=False)
    check(naive > 0.5 and bal < naive / 3 and zig <= bal + 1e-9,
          f"cp: imbalances naive {naive}, balanced {bal}, zig-zag {zig}")
    sp = np.array([1, 1, 0, 1, 0.5, 1, 1, 1], dtype=np.float64)
    cuts = cp_balance.balanced_plan(nb, R, speeds=sp)
    p = np.concatenate([[0], np.cumsum(cp_balance.block_costs(nb))])
    imb = cp_balance.plan_imbalance(cuts, nb, R, speeds=sp)
    check(p[cuts[3]] - p[cuts[2]] == 0 and np.isfinite(imb),
          "cp: the dead rank got blocks")
    tp = cp_balance.balanced_plan_two_phase(nb, R)
    i_tp = cp_balance.plan_imbalance(tp, nb, R)
    check(tp[0] == 0 and tp[-1] == nb and (np.diff(tp) >= 0).all()
          and bal - 1e-12 <= i_tp <= naive + 1e-9,
          f"cp: two-phase plan {tp.tolist()} invalid or out of bounds")
    out, replanned = cp_balance.replan_contiguous(
        base, 96, two_phase=True, policy=policy.TwoPhaseHysteresis())
    check(replanned and np.array_equal(out, cp_balance.balanced_plan(96, R)),
          "cp: a 50% context growth did not escalate to the exact split")
    cp_ms = (time.perf_counter() - t0) * 1e3

    # -- 18. MoE expert placement -----------------------------------------
    t0 = time.perf_counter()
    counts = moe_placement.simulate_router_counts(16, 32, skew=1.2)
    plan = moe_placement.plan_expert_placement(counts, 16)
    check(plan.partition.is_valid()
          and plan.load_imbalance < plan.uniform_imbalance,
          "moe: placement invalid or no better than the uniform grid")
    spm = np.ones(16)
    spm[5] = 0.0
    plan_sp = moe_placement.plan_expert_placement(counts, 16, speeds=spm)
    loads = np.asarray(plan_sp.partition.loads(prefix.prefix_sum_2d(counts)))
    check(float(loads[5]) == 0.0 and not plan_sp.fell_back
          and np.isinf(plan_sp.uniform_imbalance)
          and np.isfinite(plan_sp.load_imbalance),
          "moe: the dead rank hosts experts, or the plan fell back")
    moe_ms = (time.perf_counter() - t0) * 1e3
    log("dist", f"cp_balance {nb} blocks over {R} ranks: imbalance "
        f"equal-count {naive:.4f}, balanced {bal:.4f}, zig-zag {zig:.4f}, "
        f"two-phase {i_tp:.4f}, with a dead and a half-speed rank "
        f"{imb:.4f} (dead rank empty), a grown context escalates to the "
        f"exact split; {cp_ms:.1f} ms on the host. moe_placement 16 layers "
        f"x 32 experts over 16 ranks: imbalance {plan.load_imbalance:.4f} "
        f"against the uniform grid's {plan.uniform_imbalance:.4f}, with "
        f"rank 5 dead {plan_sp.load_imbalance:.4f} (rank 5 empty, no "
        f"fallback); {moe_ms:.1f} ms on the host (NumPy, nothing on the "
        f"card)")


N_1D = (4096, 1048576)   # the exact 1D solver's rows: K2 stages the first
M_OPT = 24               # jag-m-opt-device on a 64x64 frame
N_DEAD = 8               # dead parts among the 1024 speeds


def _rects(part) -> list:
    return [(r.r0, r.r1, r.c0, r.c1) for r in part.rects]


def _rel_bottleneck(part, gamma, speeds) -> float:
    loads = part.loads(gamma).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.where(loads > 0, loads / speeds, 0.0).max())


def run_registry(cuda: torch.device) -> list:
    """The paper's algorithm registry on the card (``core.registry``): the
    device-backed names at the paper's width with their own launch counts,
    each held against the CPU path and the host engine, then the exact 1D
    solver on a 4 MB row through K2's general route.  Returns the
    kernels' record entry of ``probe_general``."""
    from repro_torch.core import device, oned, prefix, registry, sgorp
    from repro_torch.kernels import _build
    from repro_torch.kernels.probe import ops as probe_ops
    from repro_torch.kernels.probe import ref as probe_ref
    from repro_torch.rebalance import stream

    # -- 16. data ----------------------------------------------------------
    rng = np.random.default_rng(SEED + 2)
    g_int = prefix.prefix_sum_2d(prefix.pic_like_instance(
        N1, N2, iteration=20_000, seed=SEED))
    check(g_int[-1, -1] < 2 ** 30, "the int32 frame's total must stay below "
          "2**30 (P7)")
    g_f32 = prefix.prefix_sum_2d(stream.refinement_bursts(
        1, N1, N2, seed=SEED)[0]).astype(np.float32)
    check(g_f32[-1, -1] < F32_EXACT, "the float32 frame's total must stay "
          "below 2**24")
    speeds = rng.uniform(0.25, 4.0, M)
    speeds[rng.choice(M, N_DEAD, replace=False)] = 0.0
    g_opt = prefix.prefix_sum_2d(prefix.pic_like_instance(
        64, 64, iteration=20_000, seed=SEED))
    rows = {}
    for n in N_1D:
        loads = rng.integers(0, 1000, n)
        loads[rng.choice(n, 16, replace=False)] = 200_000   # a few spikes
        rows[n] = np.concatenate([[0], np.cumsum(loads)]).astype(np.int32)
        check(int(rows[n][-1]) < 2 ** 30, "1D totals must stay below 2**30")
    pq = {"P": P, "Q": Q}

    # -- 17. the registry's device names on the card -----------------------
    # K2's inputs and outputs as the phase gives them: the first and the
    # last call at each (shape, dtype, candidates, cap), held to the plain
    # version in section 18
    k2_calls = {}
    k2_launch = probe_ops.probe_counts

    def k2_tap(p, Ls, cap):
        out = k2_launch(p, Ls, cap)
        key = (tuple(p.shape), str(p.dtype).removeprefix("torch."),
               Ls.shape[1], cap)
        rec = (p.clone(), Ls.clone(), out.clone())
        k2_calls.setdefault(key, [rec, rec])[1] = rec
        return out

    probe_ops.probe_counts = k2_tap
    _build.launches.clear()
    on_card, secs = {}, {}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        return out

    on_card["int32"] = timed("jag-pq-opt-device int32", lambda: (
        registry.partition("jag-pq-opt-device", g_int, M, **pq)))
    on_card["float32"] = timed("jag-pq-opt-device float32", lambda: (
        registry.partition("jag-pq-opt-device", g_f32, M, **pq)))
    on_card["speeds"] = timed("jag-pq-opt-device speeds", lambda: (
        registry.partition("jag-pq-opt-device", g_int, M, speeds=speeds,
                           **pq)))
    on_card["m-opt"] = timed(f"jag-m-opt-device m={M_OPT}", lambda: (
        registry.partition("jag-m-opt-device", g_opt, M_OPT)))
    for n in N_1D:
        on_card[n] = timed(f"nicol_optimal_device_impl n={n}", lambda n=n: (
            device.nicol_optimal_device_impl(
                torch.as_tensor(rows[n], device=cuda), M)))
    on_card["sgorp"] = timed("sgorp-2d", lambda: registry.partition(
        "sgorp-2d", g_int.astype(np.float32), M))
    report = timed("explain jag-pq-opt-device", lambda: registry.explain(
        "jag-pq-opt-device", g_int, M, **pq))
    launches = dict(_build.launches)
    probe_ops.probe_counts = k2_launch
    log("registry", f"kernel launches of the registry phase: {launches}")
    for k in ("probe", "probe_general"):
        check(launches.get(k, 0) > 0, f"kernel {k} never ran in the registry "
              f"phase")

    # -- 18. held against the plain K2, the CPU path and the host engine --
    # the 1D solver's rows (cap M) and the stripes of the column solves
    # ((T*P, N2+1), cap Q) at 15 candidates a round: walks past 1,024
    # steps and the second pass of each row's walks (K > 8)
    for key in [((1, n + 1), "int32", 15, M) for n in N_1D] + [
            ((P, N2 + 1), dt, 15, Q) for dt in ("int32", "float32")]:
        check(key in k2_calls, f"the registry phase gave K2 no call at "
              f"{key}; it did at {sorted(k2_calls)}")
    k2_err = {}
    for key, recs in sorted(k2_calls.items()):
        k2_err[key] = max(float((out - probe_ref.probe_counts_ref(
            p, Ls, key[3])).abs().max()) for p, Ls, out in recs)
        check(k2_err[key] == 0, f"K2 ({probe_ops.route(key[0][1])}) "
              f"differs from the plain version at {key}: {k2_err[key]}")
        log("registry", f"K2 {probe_ops.route(key[0][1])} at p {key[0]} "
            f"{key[1]}, {key[2]} candidates, cap {key[3]}: first and last "
            f"call of the phase = plain version (max_abs_err "
            f"{k2_err[key]})")
    def same_as_cpu(name, m, part, gamma, **kw):
        cpu = registry.partition(name, gamma, m, device="cpu", **kw)
        check(_rects(part) == _rects(cpu) and part.max_load(gamma)
              == cpu.max_load(gamma), f"{name} {kw}: card and CPU differ")

    host = registry.partition("jag-pq-opt", g_int, M, **pq)
    same_as_cpu("jag-pq-opt-device", M, on_card["int32"], g_int, **pq)
    check(on_card["int32"].max_load(g_int) == host.max_load(g_int),
          "jag-pq-opt-device int32: Lmax differs from the host jag-pq-opt")
    host_f = registry.partition("jag-pq-opt", g_f32, M, **pq)
    same_as_cpu("jag-pq-opt-device", M, on_card["float32"], g_f32, **pq)
    rel_f = abs(on_card["float32"].max_load(g_f32) / host_f.max_load(g_f32)
                - 1)
    check(rel_f <= 1e-5, f"jag-pq-opt-device float32: Lmax {rel_f:.3g} off "
          f"the host jag-pq-opt (limit 1e-5)")
    host_s = registry.partition("jag-pq-opt", g_int, M, speeds=speeds, **pq)
    got_s = _rel_bottleneck(on_card["speeds"], g_int, speeds)
    want_s = _rel_bottleneck(host_s, g_int, speeds)
    check(abs(got_s / want_s - 1) <= 1e-5, f"jag-pq-opt-device speeds: "
          f"relative bottleneck {got_s} against the host's {want_s} (limit "
          f"1e-5)")
    part_s = on_card["speeds"]
    check(part_s.is_valid() and all(part_s.rects[i].area == 0
                                    for i in np.flatnonzero(speeds == 0)),
          "jag-pq-opt-device speeds: invalid, or a dead part got a "
          "non-empty rectangle")
    same_as_cpu("jag-pq-opt-device", M, part_s, g_int, speeds=speeds, **pq)
    host_m = registry.partition("jag-m-opt", g_opt, M_OPT)
    same_as_cpu("jag-m-opt-device", M_OPT, on_card["m-opt"], g_opt)
    check(on_card["m-opt"].max_load(g_opt) == host_m.max_load(g_opt),
          "jag-m-opt-device: Lmax differs from the host jag-m-opt")
    # the host's nicol_optimal takes minutes on the 4 MB row; its
    # probe_bisect_optimal realizes the same cuts (checked on the short
    # row) in a fraction of a second
    host_1d = {N_1D[0]: oned.nicol_optimal(rows[N_1D[0]].astype(np.int64), M)}
    check(np.array_equal(host_1d[N_1D[0]], oned.probe_bisect_optimal(
        rows[N_1D[0]].astype(np.int64), M)), "host nicol_optimal and "
        "probe_bisect_optimal differ")
    host_1d[N_1D[1]] = oned.probe_bisect_optimal(
        rows[N_1D[1]].astype(np.int64), M)
    for n in N_1D:
        check(np.array_equal(on_card[n][0].cpu().numpy(), host_1d[n]),
              f"nicol_optimal_device_impl n={n}: cuts differ from the host "
              f"solver's")
    direct = sgorp.sgorp_2d(g_int.astype(np.float32), M)
    check(_rects(on_card["sgorp"]) == _rects(direct), "sgorp-2d through the "
          "registry differs from sgorp.sgorp_2d")
    names = {ev["name"] for ev in report.spans}
    check("partition.jag-pq-opt-device" in names, f"explain's spans lack "
          f"partition.jag-pq-opt-device: {sorted(names)}")
    check(_rects(report.partition) == _rects(on_card["int32"]),
          "explain's partition differs from the plain call")
    log("registry", f"jag-pq-opt-device at {N1}x{N2}, m={M} (P=Q={P}), "
        f"orient=best: int32 (total {int(g_int[-1, -1])}) card = CPU rect "
        f"for rect, Lmax {on_card['int32'].max_load(g_int)} = host "
        f"jag-pq-opt; float32 (total {float(g_f32[-1, -1]):.0f}) card = "
        f"CPU, Lmax {rel_f:.3g} off the host (limit 1e-5); speeds ({M} in "
        f"[0.25, 4), {N_DEAD} dead) card = CPU, relative bottleneck "
        f"{got_s:.6g} against the host's {want_s:.6g}, dead parts empty")
    log("registry", f"jag-m-opt-device 64x64 m={M_OPT}: card = CPU, Lmax "
        f"{on_card['m-opt'].max_load(g_opt)} = host jag-m-opt; "
        f"nicol_optimal_device_impl m={M} at n={N_1D}: cuts = host "
        f"oned.nicol_optimal (n={N_1D[0]}) and oned.probe_bisect_optimal "
        f"(both n; routes {[probe_ops.route(n + 1) for n in N_1D]}); sgorp-2d through the registry = sgorp.sgorp_2d; explain spans "
        f"hold partition.jag-pq-opt-device (summary: "
        f"{report.summary().splitlines()[0]})")
    log("registry", "host clock, first call on the card: " + "; ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in secs.items()))

    # -- 19. K2's general route at the 1D solver's shape -------------------
    n = N_1D[-1]
    key = ((1, n + 1), "int32", 15, M)
    p, cand, counts = k2_calls[key][0]      # the solver's first round
    steps = int(torch.clamp(counts, max=M).sum())
    nbytes = p.numel() * 4 + cand.numel() * 4 * 2
    b_ms, b_by = bound(nbytes, steps * (math.ceil(math.log2(n + 1)) + 2))
    entry = {
        "name": "probe_general", "route": "cuda",
        "source": "src/repro_torch/kernels/probe/probe.cu",
        "replaces": "src/repro/kernels/probe/probe.py:65",
        "launches": launches.get("probe_general", 0),
        "max_abs_err": k2_err[key],
        "ms": device_ms(lambda: probe_ops.probe_counts(p, cand, M), reps=5),
        "plain_ms": device_ms(lambda: probe_ref.probe_counts_ref(
            p, cand, M), reps=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log("probe", f"K2's general route (probe_general) at the 1D solver's "
        f"first round: a {tuple(p.shape)} int32 row, 15 candidates, cap {M}, "
        f"{steps} greedy steps: {entry['ms']:.4f} ms against a bound of "
        f"{b_ms:.4f} ms ({b_by}); plain version {entry['plain_ms']:.4f} ms")
    return [entry]


N_SERVE = 100_000   # the README's serving example at a tenth of its requests
ALPHA = 0.25             # the runtime's cost per unit of migrated load
#: the runtime phase's planner accumulators by stream: refinement-bursts
#: stays below 2**24, where float32 is exact; the PIC series lies above
#: it, where card and CPU float32 sums differ in order (P6) and float64
#: is exact on both
RUNTIME_DTYPES = {"refinement-bursts": torch.float32, "pic": torch.float64}


def ledger_diff(a, b) -> list:
    """Where two ``runtime.RunResult`` ledgers differ: every
    ``StepRecord`` field but ``wall_time`` (a host clock), exactly, and
    the final plan's arrays."""
    import dataclasses
    if len(a.records) != len(b.records):
        return [f"{len(a.records)} records vs {len(b.records)}"]
    bad = []
    for x, y in zip(a.records, b.records):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if f.name == "wall_time":
                continue
            if isinstance(u, dict) and isinstance(v, dict):
                same = u.keys() == v.keys() and all(
                    np.array_equal(u[k], v[k]) for k in u)
            else:
                same = type(u) is type(v) and u == v
            if not same:
                bad.append(f"step {x.step} {f.name}")
    bad += [f"final plan {f}" for f in ("row_cuts", "counts", "col_cuts")
            if not np.array_equal(getattr(a.final_plan, f),
                                  getattr(b.final_plan, f))]
    return bad


def run_f64(cuda: torch.device, streams: dict, host_gamma: dict,
            totals: dict) -> dict:
    """K1 in float64 against its plain version on the PIC frames (integer
    totals up to 5.2e8, exact in float64), timed beside its bound and
    ``torch.cumsum``; then the float64 plan path (``planner.plan_host(
    gamma_dtype=float64)``) with its own launch counts, held to the CPU
    path and to the exact int64 bottleneck of its own plans.  Returns K1
    float64's entry of the kernels' record."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sat import ops as sat_ops
    from repro_torch.kernels.sat import ref as sat_ref
    from repro_torch.rebalance import batch_device, planner

    # -- 20. K1 float64 against its plain version on the card -------------
    fr = streams["pic"]
    check(int(totals["pic"].max()) < 2 ** 53, "float64 planning needs the "
          "PIC frame totals below 2**53")
    rng = np.random.default_rng(SEED + 3)
    for shape in ((1, 1), (5, 7, 9), (3, 130, 257), (2, 1000, 33)):
        a = torch.as_tensor(rng.integers(0, 2 ** 30, shape),
                            device=cuda).double()
        check(torch.equal(sat_ops.gamma(a), sat_ref.gamma_ref(a)),
              f"sat float64 {shape}: kernel differs from the plain version")
    a = torch.as_tensor(fr, device=cuda).double()
    gk, gp = sat_ops.gamma(a), sat_ref.gamma_ref(a)
    err = float((gk - gp).abs().max())
    g_exact = torch.as_tensor(np.stack(host_gamma["pic"]), device=cuda)
    check(err == 0 and torch.equal(gk, g_exact.double()),
          f"sat float64 pic: kernel {err} off the plain version, or not the "
          f"exact int64 prefix")
    log("sat64", f"odd shapes (1,1), (5,7,9), (3,130,257), (2,1000,33) of "
        f"integer loads below 2**30, and the PIC frames ({T}, {N1}, {N2}) "
        f"cast to float64 (totals up to {totals['pic'].max():.3e}): "
        f"bit-identical to the plain version and to the exact int64 prefix "
        f"(max_abs_err 0)")
    del gk, gp, g_exact
    nbytes = a.numel() * 8 + T * (N1 + 1) * (N2 + 1) * 8
    b_ms, b_by = bound(nbytes, 2 * a.numel(), FP64_OPS_PER_S)
    k1 = {
        "name": "sat_f64", "route": "cuda",
        "source": "src/repro_torch/kernels/sat/sat.cu",
        "replaces": "src/repro/kernels/sat/sat.py:64",
        "launches": 0, "max_abs_err": err,
        "ms": device_ms(lambda: sat_ops.gamma(a)),
        "plain_ms": device_ms(lambda: sat_ref.gamma_ref(a)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.cumsum(torch.cumsum(
            a, dim=-2), dim=-1))}
    log("sat64", f"K1 float64 at {tuple(a.shape)}: {k1['ms']:.4f} ms "
        f"against a bound of {b_ms:.4f} ms ({nbytes} bytes in and out); "
        f"plain version {k1['plain_ms']:.4f} ms, torch.cumsum twice "
        f"{k1['library_ms']:.4f} ms; by kernel: "
        f"{by_kernel(lambda: sat_ops.gamma(a))}")
    del a

    # -- 21. the float64 plan path -----------------------------------------
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plans = planner.plan_host(fr, P=P, m=M, gamma_dtype=torch.float64)
    first_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    log("plan64", f"plan_host pic T={T} gamma_dtype=float64 in {first_s:.2f} "
        f"s (host clock, first call); kernel launches {launches}")
    check(launches.get("sat", 0) >= 1, "kernel sat never ran on the float64 "
          "plan path")
    k1["launches"] = launches.get("sat", 0)
    out = planner.plan_stream(fr, P=P, m=M, gamma_dtype=torch.float64)
    t0 = time.perf_counter()
    cpu = planner.plan_stream(fr, P=P, m=M, gamma_dtype=torch.float64,
                              device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu_plans = batch_device.unstack_plans(cpu, (N1, N2))
    same = [all(np.array_equal(getattr(x, f), getattr(y, f))
                for f in ("row_cuts", "counts", "col_cuts"))
            for x, y in zip(plans, cpu_plans)]
    check(all(same), f"float64 plans: card and CPU differ on frames "
          f"{[t for t, s in enumerate(same) if not s]}")
    check(torch.equal(out[3].cpu(), cpu[3]), "float64 Lmax: card and CPU "
          "differ")
    lmax = out[3].cpu().numpy()
    exact = np.array([pl.loads(host_gamma["pic"][t]).max()
                      for t, pl in enumerate(plans)])
    check(np.array_equal(lmax, exact.astype(np.float64)), "float64 Lmax is "
          "not the exact int64 bottleneck of its plan on every frame")
    for t, pl in enumerate(plans):
        pl.validate(host_gamma["pic"][t], m=M)

    def timed(gd) -> list:
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            planner.plan_host(fr, P=P, m=M, gamma_dtype=gd)
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs[1:]

    r32, r64 = timed(torch.float32), timed(torch.float64)
    p32 = planner.plan_host(fr, P=P, m=M)
    q32 = np.array([pl.max_load(host_gamma["pic"][t])
                    for t, pl in enumerate(p32)]) / (totals["pic"] / M)
    q64 = exact / (totals["pic"] / M)
    log("plan64", f"pic T={T}: all {T} float64 plans valid, card = CPU bit "
        f"for bit (cuts, counts, Lmax; the CPU path took {cpu_s:.2f} s), "
        f"Lmax = the exact int64 bottleneck of its plan on every frame")
    log("plan64", f"plan_host pic T={T}, host clock over 3 runs: float32 "
        f"median {statistics.median(r32):.1f} ms (min {min(r32):.1f}, max "
        f"{max(r32):.1f}), float64 median {statistics.median(r64):.1f} ms "
        f"(min {min(r64):.1f}, max {max(r64):.1f}); Lmax / (total/m) on the "
        f"exact prefix: float32 mean {q32.mean():.6f} (max {q32.max():.6f}), "
        f"float64 mean {q64.mean():.6f} (max {q64.max():.6f})")
    return k1


def _runtime_policies() -> dict:
    from repro_torch.rebalance import policy
    return {"never": policy.NeverRebalance(),
            "always": policy.AlwaysRebalance(),
            "every8": policy.EveryK(8),
            "hysteresis": policy.HysteresisPolicy(),
            "two-phase": policy.TwoPhaseHysteresis()}


def _walls(res) -> str:
    w = np.array([r.wall_time for r in res.records]) * 1e3
    return (f"step wall_time median {np.median(w):.2f} ms, max "
            f"{w.max():.2f} ms")


def run_runtime(cuda: torch.device, streams: dict, totals: dict) -> None:
    """The rebalance runtime on the card: ``runtime.compare_policies`` over
    both streams with five policies, each ledger held to the CPU path's,
    then ``run_stream`` with fault-aware hysteresis under both fault
    scenarios, migrations executed and plans validated, with its own
    launch counts."""
    from repro_torch.kernels import _build
    from repro_torch.rebalance import faults, runtime

    # -- 22. compare_policies on the card against the CPU -----------------
    _build.launches.clear()
    card, overhead = {}, {}
    for name, fr in streams.items():
        overhead[name] = float(totals[name].mean()) / M
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[name] = runtime.compare_policies(
            fr, _runtime_policies(), P=P, m=M, alpha=ALPHA,
            replan_overhead=overhead[name],
            gamma_dtype=RUNTIME_DTYPES[name])
        log("runtime", f"{name}: compare_policies T={T}, 5 policies, "
            f"gamma_dtype {RUNTIME_DTYPES[name]}, alpha {ALPHA}, "
            f"replan_overhead {overhead[name]:.1f} (mean frame total / m), "
            f"in {time.perf_counter() - t0:.2f} s (host clock)")
    launches = dict(_build.launches)
    log("runtime", f"kernel launches over both compare_policies: {launches}")
    check(launches.get("sat", 0) >= 1, "kernel sat never ran in the "
          "runtime's planning")
    for name, fr in streams.items():
        t0 = time.perf_counter()
        cpu = runtime.compare_policies(
            fr, _runtime_policies(), P=P, m=M, alpha=ALPHA,
            replan_overhead=overhead[name],
            gamma_dtype=RUNTIME_DTYPES[name], device="cpu")
        cpu_s = time.perf_counter() - t0
        for pol, res in card[name].items():
            bad = ledger_diff(res, cpu[pol])
            check(not bad, f"{name} {pol}: the card's ledger differs from "
                  f"the CPU path's: {bad[:5]}")
            log("runtime", f"{name} {pol}: {res.summary()}; "
                f"{_walls(res)}")
        log("runtime", f"{name}: every ledger equals the CPU path's (all "
            f"StepRecord fields but wall_time, and the final plans; the CPU "
            f"path took {cpu_s:.2f} s)")

    # -- 23. faults, migrations executed ----------------------------------
    # a tap on the capacity-aware planner keeps every plan it gives the
    # runtime, with the speeds it was given
    capacity_plan = faults.capacity_plan
    adopted = []

    def tap(g, *, P, m, speeds=None, optimal=True):
        plan = capacity_plan(g, P=P, m=m, speeds=speeds, optimal=optimal)
        adopted.append((np.asarray(speeds), plan))
        return plan

    faults.capacity_plan = tap
    try:
        for scenario in ("random-failures", "rack-failure"):
            adopted.clear()
            _run_faults(scenario, streams["refinement-bursts"],
                        overhead["refinement-bursts"], adopted)
    finally:
        faults.capacity_plan = capacity_plan


def _run_faults(scenario: str, fr: np.ndarray, ro: float,
                adopted: list) -> None:
    """``run_stream`` with fault-aware hysteresis under one fault scenario,
    migrations executed and plans validated, with its own launch counts;
    ``adopted`` holds the capacity-aware planner's plans of the run."""
    from repro_torch.core import search
    from repro_torch.kernels import _build
    from repro_torch.rebalance import faults, policy, runtime

    sched = faults.FAULT_SCENARIOS[scenario](T, M, seed=0)
    _build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runtime.run_stream(fr, policy.FaultAwareHysteresis(), P=P, m=M,
                             alpha=ALPHA, replan_overhead=ro, faults=sched,
                             execute=True, validate=True)
    run_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    for k in ("sat", "rectload"):
        check(launches.get(k, 0) >= 1, f"kernel {k} never ran in run_stream "
              f"under {scenario}")
    replans = [r for r in res.records[1:] if r.replanned]
    check(replans and all(r.executed_bytes == r.migration_volume
                          for r in replans),
          f"{scenario}: executed bytes differ from the priced migration "
          f"volume")
    fails = sorted({e.step for e in sched.events if e.kind == "fail"})
    forced = [r.step for r in res.records if r.forced]
    check(forced == fails and all(res.records[t].replanned for t in fails),
          f"{scenario}: forced replans at {forced}, failures at {fails}")
    check(all(np.isfinite(r.max_load) for r in res.records),
          f"{scenario}: a dead part kept load")
    for sp, plan in adopted:
        dead = np.flatnonzero(sp == 0)
        check(not np.isin(dead, plan.owner_map()).any(),
              f"{scenario}: a plan gives cells to dead parts {dead}")
    check(not np.isin(sched.failed_at(T - 1),
                      res.final_plan.owner_map()).any(),
          f"{scenario}: the final plan gives cells to dead parts")
    degraded = sum(search.normalize_speeds(sched.speeds_at(r.step), M)
                   is not None for r in replans)
    check(len(adopted) == degraded, f"{scenario}: {degraded} replans under "
          f"degraded capacity, {len(adopted)} capacity-aware plans")
    moved = sum(r.executed_bytes for r in replans)
    step_ms = {r.step: r.wall_time * 1e3 for r in res.records}
    log("faults", f"{scenario}: step 0 {step_ms[0]:.1f} ms (it waits for "
        f"plan_iter to enqueue every slice), forced replans " + ", ".join(
            f"step {t} {step_ms[t]:.1f} ms" for t in fails)
        + ", other replans " + ", ".join(
            f"step {r.step} ({r.mode}) {step_ms[r.step]:.1f} ms"
            for r in replans if not r.forced))
    log("faults", f"{scenario} ({len(sched.events)} events: "
        + ", ".join(f"{e.kind} part {e.part} at {e.step}"
                    for e in sched.events)
        + f"): run_stream with fault-aware hysteresis, execute and validate, "
        f"in {run_s:.2f} s; {res.summary()}; "
        f"forced at {forced}; evacuated {res.evacuation_volume:.0f}; "
        f"executed {moved:.0f} = priced on all {len(replans)} replans; "
        f"{len(adopted)} capacity-aware plans, none with cells on a dead "
        f"part; {_walls(res)}; launches {launches}")


def run_serve() -> None:
    """The serve simulator (host NumPy, nothing on the card): the README's
    example at a tenth of its requests."""
    from repro_torch.rebalance import policy
    from repro_torch.serve import simulate

    # -- 24. serving ---------------------------------------------------------
    t0 = time.perf_counter()
    res = simulate.simulate(
        simulate.poisson_arrivals(N_SERVE, rate=400.0, seed=SEED),
        n_replicas=8, service_rate=16000.0, tick=0.1,
        policy=policy.TwoPhaseHysteresis())
    host_s = time.perf_counter() - t0
    check(res.admitted == N_SERVE
          and res.completed + res.evicted == res.admitted,
          f"serve: admitted {res.admitted}, completed {res.completed}, "
          f"evicted {res.evicted}")
    check(res.hist.count == res.completed > 0, "serve: the latency "
          "histogram is empty or misses completions")
    p50, p99 = res.percentile([50, 99])
    log("serve", f"simulate {N_SERVE} Poisson requests at rate 400, 8 "
        f"replicas, service rate 16000, tick 0.1, two-phase hysteresis: "
        f"{res.completed} completed, {res.evicted} evicted; throughput "
        f"{res.throughput:.1f} requests per simulated time unit; latency "
        f"p50 {p50:.4f}, p99 {p99:.4f} (histogram p50 "
        f"{res.hist.percentile(50):.4f}, p99 {res.hist.percentile(99):.4f}); "
        f"replans {res.replans}; migrated {res.migrated_tokens} tokens; "
        f"host time {host_s:.2f} s (NumPy on the host, nothing on the card)")


# K5's shapes: (name, source, query heads, KV heads, head dim, window,
# softcap); B=1 and S=8192 (Gemma-2's context length) for all three
FLASH_SHAPES = [
    ("gemma2-9b local", "src/repro/configs/gemma2_9b.py", 16, 8, 256, 4096,
     50.0),
    ("gemma2-9b global", "src/repro/configs/gemma2_9b.py", 16, 8, 256, 0,
     50.0),
    ("qwen3-0.6b", "src/repro/configs/qwen3_0_6b.py", 16, 8, 128, 0, 0.0),
]
S_FLASH = 8192
Q_STD_SOFTCAP = 8.0   # logits of standard deviation 8 where softcap is 50
FLASH_REL_L2 = 1e-2   # ||kernel - plain|| / ||plain|| in bf16


def flex_yardstick(qf, kf, vf, window: int, softcap: float):
    """The library yardstick where SDPA has no softcap: compiled
    ``flex_attention`` with the softcap as its score modifier and causal
    (and window) as its block mask, on the folded ``(BH, S, d)`` inputs.
    Timed only; the port never calls it."""
    import torch._inductor.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    torch._inductor.config.compile_threads = 1   # no compile worker pool

    def keep(b, h, iq, jk):
        ok = jk <= iq
        return ok & (iq - jk < window) if window > 0 else ok

    def cap(s, b, h, iq, jk):
        return softcap * torch.tanh(s / softcap)

    S = qf.shape[1]
    mask = create_block_mask(keep, None, None, S, S, device=qf.device)
    flex = torch.compile(flex_attention)
    q4, k4, v4 = qf[None], kf[None], vf[None]

    def call():
        return flex(q4, k4, v4, score_mod=cap, block_mask=mask)[0]
    return call, "flex_attention, compiled, softcap score_mod, block mask"


def causal_pairs(S: int, window: int) -> int:
    """Unmasked (i, j) pairs of one head under the causal mask (and the
    window, where > 0)."""
    kept = np.arange(1, S + 1, dtype=np.int64)
    return int((np.minimum(kept, window) if window > 0 else kept).sum())


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base lies one element past the
    start of its buffer, so not on a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def run_flash(cuda: torch.device) -> list:
    """K5 at full model width: ``ops.attention`` on the three shapes with
    its own launch counts (the Hopper kernel), then the same inputs at
    unaligned bases through ``ops.flash_attention`` with their own launch
    counts (the general kernel), each output against the plain version on
    the card, one float32 check, and times.  Returns K5's two entries of
    the kernels' record, ``flash`` and ``flash_mma`` (top-level numbers at
    the Qwen3 shape, the one with SDPA as its yardstick; every shape's
    numbers under ``shapes``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls must run in full float32")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    # -- 12. data: random q, k, v from a seed, on the card -----------------
    # Where there is a softcap, q has standard deviation Q_STD_SOFTCAP, so
    # the logits spread as far (the largest reach about 50) and the softcap
    # changes them; elsewhere q, k and v are unit normals.
    inputs = {}
    for name, _, H, Hkv, d, _, softcap in FLASH_SHAPES:
        q = normal((1, S_FLASH, H, d), torch.float32)
        q = (q * (Q_STD_SOFTCAP if softcap else 1.0)).to(torch.bfloat16)
        k, v = (layers.repeat_kv(normal((1, S_FLASH, Hkv, d),
                                        torch.bfloat16), H // Hkv)
                for _ in range(2))
        inputs[name] = (q, k, v)

    # -- 13. the attention path at full width -----------------------------
    _build.launches.clear()
    outs = {}
    t0 = time.perf_counter()
    for name, _, H, _, d, window, softcap in FLASH_SHAPES:
        q, k, v = inputs[name]
        outs[name] = flash_ops.attention(q, k, v, causal=True, window=window,
                                         softcap=softcap)
    torch.cuda.synchronize()
    log("flash", f"attention on the 3 shapes in "
        f"{time.perf_counter() - t0:.2f} s (host clock, first calls)")
    launches = dict(_build.launches)
    log("flash", f"kernel launches on the attention path: {launches}")
    check(launches.get("flash", 0) >= len(FLASH_SHAPES)
          and launches.get("flash_mma", 0) == 0,
          "the attention path did not take the Hopper kernel (flash) at "
          "every shape, or took the general one (flash_mma)")

    def fold(x):
        return x.transpose(1, 2).reshape(-1, S_FLASH,
                                         x.shape[-1]).contiguous()

    # -- 14. the general bf16 route at full width -------------------------
    # The same inputs, folded, at bases TMA cannot describe: the C entry
    # point gives every shape to the general mma.sync kernel.
    general = {name: tuple(unaligned(fold(x)) for x in inputs[name])
               for name, *_ in FLASH_SHAPES}
    check(all(x.data_ptr() % 16 != 0 for g in general.values() for x in g),
          "flash: the unaligned copies lie on 16-byte boundaries")
    _build.launches.clear()
    gouts = {}
    for name, _, _, _, _, window, softcap in FLASH_SHAPES:
        gouts[name] = flash_ops.flash_attention(
            *general[name], causal=True, window=window, softcap=softcap)
    torch.cuda.synchronize()
    glaunches = dict(_build.launches)
    log("flash", f"kernel launches on the general route (unaligned "
        f"bases): {glaunches}")
    check(glaunches.get("flash_mma", 0) == len(FLASH_SHAPES)
          and glaunches.get("flash", 0) == 0,
          "the unaligned inputs did not take the general kernel "
          "(flash_mma) at every shape, or took the Hopper one (flash)")

    def rel_l2(got, want):
        return float((got - want).norm() / want.norm())

    def held_to_plain(name, route, got, want):
        """max |got - want| and relative L2, both checked."""
        e = float((got - want).abs().max())
        rel = rel_l2(got, want)
        check(torch.allclose(got, want, rtol=2e-2, atol=2e-2),
              f"flash {name} ({route}): kernel is {e:.3g} off the plain "
              f"version (limit rtol = atol = 2e-2)")
        check(rel <= FLASH_REL_L2, f"flash {name} ({route}): kernel's "
              f"relative L2 error {rel:.3g} (limit {FLASH_REL_L2})")
        return e, rel

    rows, grows, err, gerr = [], [], 0.0, 0.0
    for name, src, H, Hkv, d, window, softcap in FLASH_SHAPES:
        q, k, v = inputs[name]
        out = outs[name]
        check(out.shape == (1, S_FLASH, H, d) and out.dtype == torch.bfloat16
              and bool(torch.isfinite(out).all()),
              f"flash {name}: output is not finite bf16 of shape "
              f"{(1, S_FLASH, H, d)}")
        qf, kf, vf = fold(q), fold(k), fold(v)
        kw = dict(causal=True, window=window, softcap=softcap)
        want = flash_ref.attention_ref(qf, kf, vf, **kw).float()
        got = fold(out).float()
        e, rel = held_to_plain(name, "flash", got, want)
        gout = gouts[name]
        check(gout.shape == qf.shape and gout.dtype == torch.bfloat16
              and bool(torch.isfinite(gout).all()),
              f"flash {name} (flash_mma): output is not finite bf16 of "
              f"shape {tuple(qf.shape)}")
        ge, grel = held_to_plain(name, "flash_mma", gout.float(), want)
        held = (f"max |kernel - plain| {e:.3g} (held at rtol = atol = "
                f"2e-2), relative L2 {rel:.3g} (limit {FLASH_REL_L2}; "
                f"|plain| median {float(want.abs().median()):.3g}, max "
                f"{float(want.abs().max()):.3g})")
        if softcap:
            # the data is such that a kernel ignoring the softcap would fail
            nocap = flash_ref.attention_ref(qf, kf, vf, causal=True,
                                            window=window).float()
            rel_nocap = rel_l2(nocap, want)
            del nocap
            check(rel_nocap > FLASH_REL_L2, f"flash {name}: without the "
                  f"softcap the plain version moves by only {rel_nocap:.3g}"
                  f" (relative L2), within the limit: the check cannot see "
                  f"the softcap")
            held += (f"; the plain version without the softcap is "
                     f"{rel_nocap:.3g} off (relative L2)")
        err, gerr = max(err, e), max(gerr, ge)
        pairs = causal_pairs(S_FLASH, window)
        nbytes = 4 * qf.numel() * qf.element_size()   # q, k, v in; out
        b_ms, b_by = bound(nbytes, 4 * qf.shape[0] * d * pairs,
                           BF16_TC_OPS_PER_S)
        row = {"shape": name, "source": src, "B": 1, "S": S_FLASH, "H": H,
               "kv_heads": Hkv, "d": d, "window": window,
               "softcap": softcap, "max_abs_err": e, "rel_l2_err": rel,
               "ms": device_ms(lambda: flash_ops.flash_attention(
                   qf, kf, vf, **kw)),
               "plain_ms": device_ms(lambda: flash_ref.attention_ref(
                   qf, kf, vf, **kw), reps=5),
               "bound_ms": b_ms, "bound_by": b_by}
        if softcap:
            lib_fn, lib_name = flex_yardstick(qf, kf, vf, window, softcap)
        else:
            def lib_fn(q4=qf[None], k4=kf[None], v4=vf[None]):
                return torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True)[0]
            lib_name = "SDPA, is_causal"
        lib_out = lib_fn().float()
        lib_rel = rel_l2(lib_out, want)
        lib_err = float((lib_out - got).abs().max())
        del lib_out, want, got
        check(lib_rel <= FLASH_REL_L2, f"flash {name}: the library yardstick "
              f"({lib_name}) is {lib_rel:.3g} off the plain version "
              f"(relative L2): it does not compute this function")
        row["library_ms"] = device_ms(lib_fn)
        lib = (f"library_ms {row['library_ms']:.4f} ({lib_name}; a "
               f"yardstick only: relative L2 {lib_rel:.3g} off the plain "
               f"version, max |library - kernel| {lib_err:.3g})")
        grow = dict(row, max_abs_err=ge, rel_l2_err=grel,
                    ms=device_ms(lambda: flash_ops.flash_attention(
                        *general[name], **kw)))
        log("flash", f"{name} ({src}): q (1, {S_FLASH}, {H}, {d}) bf16, "
            f"{Hkv} KV heads repeated to {H}, causal, window {window}, "
            f"softcap {softcap}: {held}; "
            f"ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, bound_ms "
            f"{b_ms:.4f} ({b_by}; {pairs * H} unmasked pairs, {nbytes} "
            f"bytes); {lib}; general route (flash_mma, unaligned copies): "
            f"max |kernel - plain| {ge:.3g}, relative L2 {grel:.3g}, ms "
            f"{grow['ms']:.4f}")
        rows.append(row)
        grows.append(grow)
        del qf, kf, vf, lib_fn
    del inputs, outs, general, gouts
    torch.cuda.empty_cache()
    by = {r["shape"]: r for r in rows}
    ratio = by["gemma2-9b local"]["ms"] / by["gemma2-9b global"]["ms"]
    pair_ratio = causal_pairs(S_FLASH, 4096) / causal_pairs(S_FLASH, 0)
    log("flash", f"local/global time {ratio:.3f} (unmasked pairs "
        f"{pair_ratio:.3f}): the key-tile skip under the window")

    # float32: Qwen3 width at S=2048, CUDA-core FMA, against the plain
    # version in full float32; SDPA on float32 as its yardstick, held to
    # the same relative L2
    S32 = 2048
    q, k, v = (normal((16, S32, 128), torch.float32) for _ in range(3))
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = flash_ref.attention_ref(q, k, v, causal=True)
    e32, rel32 = float((got - want).abs().max()), rel_l2(got, want)
    check(torch.allclose(got, want, rtol=2e-5, atol=2e-5), f"flash float32: "
          f"kernel is {e32:.3g} off the plain version (limit rtol = atol = "
          f"2e-5)")
    check(rel32 <= 1e-5, f"flash float32: kernel's relative L2 error "
          f"{rel32:.3g} (limit 1e-5)")
    b32, b32_by = bound(4 * q.numel() * 4,
                        4 * 16 * 128 * causal_pairs(S32, 0))

    def sdpa32(q4=q[None], k4=k[None], v4=v[None]):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)[0]
    lib_rel32 = rel_l2(sdpa32(), want)
    lib32 = device_ms(sdpa32) if lib_rel32 <= 1e-5 else None
    row32 = {"shape": "qwen3-0.6b float32", "B": 1, "S": S32, "H": 16,
             "d": 128, "window": 0, "softcap": 0.0, "max_abs_err": e32,
             "rel_l2_err": rel32,
             "ms": device_ms(lambda: flash_ops.flash_attention(
                 q, k, v, causal=True)),
             "plain_ms": device_ms(lambda: flash_ref.attention_ref(
                 q, k, v, causal=True), reps=5),
             "bound_ms": b32, "bound_by": b32_by, "library_ms": lib32}
    rows.append(row32)
    log("flash", f"float32 (16, {S32}, 128) causal: max |kernel - plain| "
        f"{e32:.3g} (held at rtol = atol = 2e-5), relative L2 {rel32:.3g} "
        f"(limit 1e-5); ms {row32['ms']:.4f}, plain_ms "
        f"{row32['plain_ms']:.4f}, bound_ms {b32:.4f} (float32 CUDA "
        f"cores); library_ms {lib32} (SDPA on float32, relative L2 "
        f"{lib_rel32:.3g} off the plain version"
        + ("" if lib32 is not None else ": above 1e-5, so not timed as "
           "this function") + ")")
    del q, k, v, got, want

    def entry(name, n, e, shape_rows):
        top = next(r for r in shape_rows if r["shape"] == "qwen3-0.6b")
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash/flash.cu",
            "replaces": "src/repro/kernels/flash/flash.py:94",
            "launches": n, "max_abs_err": e,
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "shapes": shape_rows}
    return [entry("flash", launches.get("flash", 0), err, rows),
            entry("flash_mma", glaunches.get("flash_mma", 0), gerr, grows)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    from repro_torch.core import device, prefix
    from repro_torch.kernels import _build
    from repro_torch.kernels.probe import ops as probe_ops
    from repro_torch.kernels.probe import ref as probe_ref
    from repro_torch.kernels.rectload import ops as rl_ops
    from repro_torch.kernels.rectload import ref as rl_ref
    from repro_torch.kernels.sat import ops as sat_ops
    from repro_torch.kernels.sat import ref as sat_ref
    from repro_torch.rebalance import (batch_device, execute, migrate,
                                       planner, stream)

    cuda = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} on {kind}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log("build", f"kernels built in {time.perf_counter() - t0:.1f} s into "
        f"{_build.BUILD_DIR}")

    # -- 2. data -----------------------------------------------------------
    t0 = time.perf_counter()
    streams = {"refinement-bursts": stream.refinement_bursts(T, N1, N2,
                                                             seed=SEED),
               "pic": stream.pic_series(T, N1, N2, seed=SEED)}
    host_gamma = {k: [prefix.prefix_sum_2d(f) for f in v]
                  for k, v in streams.items()}
    totals = {k: np.array([g[-1, -1] for g in v])
              for k, v in host_gamma.items()}
    log("data", f"T={T} {N1}x{N2} frames made in "
        f"{time.perf_counter() - t0:.1f} s; largest frame totals: "
        + ", ".join(f"{k} {int(v.max())}" for k, v in totals.items()))
    exact_f32 = {k: bool(v.max() < F32_EXACT) for k, v in totals.items()}

    # -- 3. kernels against their plain versions on the card ---------------
    err = {"sat": 0.0, "probe": 0.0, "rectload": 0.0}
    for name, fr in streams.items():
        a64 = torch.as_tensor(fr, device=cuda)
        g_exact = torch.as_tensor(np.stack(host_gamma[name]), device=cuda)
        for dt in (torch.int32, torch.float32):
            a = a64.to(dt)
            gk, gp = sat_ops.gamma(a), sat_ref.gamma_ref(a)
            d = float((gk.double() - gp.double()).abs().max())
            err["sat"] = max(err["sat"], d)
            if dt == torch.int32 or exact_f32[name]:
                check(d == 0, f"sat {name} {dt}: kernel differs from the "
                      f"plain version by {d}")
                log("sat", f"{name} {dt}: bit-identical to the plain version")
                continue
            tot = torch.as_tensor(totals[name], device=cuda,
                                  dtype=torch.float64)[:, None, None]
            rk = float(((gk.double() - g_exact.double()).abs() / tot).max())
            rp = float(((gp.double() - g_exact.double()).abs() / tot).max())
            check(rk <= 1e-6, f"sat {name} float32: kernel is {rk:.3g} x "
                  f"the frame total off the exact prefix (limit 1e-6)")
            log("sat", f"{name} float32 (frame totals up to "
                f"{totals[name].max():.3e}, float32 is exact below 2**24): "
                f"kernel vs plain max|d| {d}; kernel vs the exact int64 "
                f"prefix {rk:.3g} x frame total (limit 1e-6); plain cumsum "
                f"vs exact {rp:.3g}")

    rng = np.random.default_rng(SEED)
    rows = torch.arange(0, N1 + 1, N1 // P, device=cuda)   # P equal stripes
    for name in streams:
        g = torch.as_tensor(np.stack(host_gamma[name]), device=cuda)
        sm = (g[:, rows[1:]] - g[:, rows[:-1]]).reshape(T * P, N2 + 1)
        sm = torch.cat([sm, torch.zeros_like(sm[:1])])      # a zero-load row
        S = sm.shape[0]
        hi = (2 * sm[:, -1] // Q + 2).cpu().numpy()
        Ls = rng.integers(0, hi[:, None], (S, 8))
        Ls[:, 0] = 0                                        # L = 0
        maxel = torch.diff(sm, dim=1).amax(dim=1).cpu().numpy()
        Ls[:, 1] = np.maximum(maxel - 1, 0)                 # L < max element
        for dt in (torch.int32, torch.float32):
            p, L = sm.to(dt), torch.as_tensor(Ls, device=cuda).to(dt)
            ck = probe_ops.probe_counts(p, L, Q)
            cp = probe_ref.probe_counts_ref(p, L, Q)
            check(torch.equal(ck, cp), f"probe {name} {dt}: kernel differs "
                  f"from the plain version")
            if dt == torch.int32:
                check(bool((ck[:-1, 1] == Q + 1).all()), f"probe {name}: "
                      f"L < max element must report cap+1")
                check(bool((ck[-1] == 1).all()), f"probe {name}: a "
                      f"zero-load row must count 1")
    empty = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    ce = probe_ops.probe_counts(empty, torch.zeros((4, 3), dtype=torch.int32,
                                                   device=cuda), Q)
    check(torch.equal(ce, probe_ref.probe_counts_ref(
        empty, torch.zeros((4, 3), dtype=torch.int32, device=cuda), Q))
        and bool((ce == 1).all()), "probe: an empty row must count 1")
    log("probe", f"{T * P + 1} stripe rows of each stream x 8 candidates "
        f"(L=0, L < max element, random) and a zero-load row, int32 and "
        f"float32, plus empty rows: bit-identical to the plain version")

    heur_out = {}
    for name, fr in streams.items():
        heur_out[name] = planner.plan_stream(fr, P=P, m=M)
        rc, _, cc, _ = heur_out[name]
        g32 = torch.as_tensor(np.stack(host_gamma[name]), device=cuda)
        for gd in (torch.float32, torch.int32):
            g = g32.to(gd)
            lk = rl_ops.jagged_loads(g, rc, cc)
            lp = rl_ref.jagged_loads_ref(g, rc, cc).to(torch.float32)
            check(torch.equal(lk, lp), f"rectload {name} {gd}: kernel "
                  f"differs from the plain version")
    log("rectload", f"{T} plans of each stream in one launch ({T}, {P}, "
        f"{M - P + 1}) on float32 and int32 Gammas: bit-identical to the "
        f"plain version")

    # -- 4-6. main path ----------------------------------------------------
    _build.launches.clear()
    plans = {}
    for name, frames in streams.items():
        for exact in (False, True):
            tag = f"{name} {'exact' if exact else 'heuristic'}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = planner.plan_stream(frames, P=P, m=M, exact=exact)
            ps = batch_device.unstack_plans(out, (N1, N2))
            dt_s = time.perf_counter() - t0
            for t, pl in enumerate(ps):
                pl.validate(host_gamma[name][t], m=M)
            lm = np.array([pl.max_load(host_gamma[name][t])
                           for t, pl in enumerate(ps)])
            check(np.array_equal(lm, out[3].cpu().numpy().astype(np.float64))
                  or not (exact or exact_f32[name]),
                  f"{tag}: Lmax differs from the plans' own max load")
            ratio = lm / (totals[name][:len(ps)] / M)
            log("plan", f"{tag}: T={len(ps)} planned in {dt_s:.2f} s (host "
                f"clock, first call); all plans valid (Plan.validate on the "
                f"int64 Gamma, m={M}); Lmax / (total/m) from "
                f"{ratio.min():.4f} to {ratio.max():.4f}")
            cpu = planner.plan_stream(frames[:4], P=P, m=M, exact=exact,
                                      device="cpu")
            same = [torch.equal(a[:4].cpu(), b) for a, b in zip(out, cpu)]
            if exact or exact_f32[name]:
                check(all(same), f"{tag}: card and CPU differ on 4 frames "
                      f"(row_cuts, counts, col_cuts, Lmax: {same})")
                log("plan", f"{tag}: 4 frames at full width, card = CPU bit "
                    f"for bit (row_cuts, counts, col_cuts, Lmax)")
            else:
                rel = float(((out[3][:4].cpu().double() - cpu[3].double())
                             .abs() / cpu[3].double()).max())
                check(rel <= 1e-2, f"{tag}: Lmax {rel:.3g} off the CPU "
                      f"path (limit 1e-2)")
                log("plan", f"{tag}: 4 frames at full width, max |dLmax|/"
                    f"Lmax {rel:.3g} against the CPU path (limit 1e-2); "
                    f"cuts {'equal' if all(same[:3]) else 'differ'} "
                    f"(frame totals above 2**24: float32 sums may be taken "
                    f"in another order)")
            plans[(name, exact)] = ps

    for name, fr in streams.items():
        worst = 0.0
        for t, pl in enumerate(plans[(name, False)]):
            got = execute.plan_rect_loads(pl, fr[t])
            want = pl.loads(host_gamma[name][t])
            if exact_f32[name]:
                check(np.array_equal(got, want), f"price {name} frame {t}: "
                      f"rectload loads differ from Plan.loads")
            worst = max(worst, float(np.abs(got - want).max() / want.max()))
        log("price", f"{name}: execute.plan_rect_loads on {T} plans, max "
            f"|d|/max load {worst:.3g} against Plan.loads on the int64 "
            f"Gamma ({'exact, as required below 2**24' if exact_f32[name] else 'float32 Gamma above 2**24'})")

    t0 = time.perf_counter()
    rb_plans = plans[("refinement-bursts", False)]
    rb = streams["refinement-bursts"]
    moved = 0.0
    for t in range(T - 1):
        rec = execute.execute_migration(rb_plans[t], rb_plans[t + 1], rb[t + 1])
        execute.verify_receipt(rb_plans[t], rb_plans[t + 1], rb[t + 1],
                               receipt=rec)
        moved += rec.executed_bytes
    vol = sum(migrate.migration_volume(rb_plans[t], rb_plans[t + 1],
                                       rb[t + 1]) for t in range(T - 1))
    log("migrate", f"refinement-bursts: {T - 1} executed migrations, "
        f"receipts verified at zero tolerance; moved {moved:.0f} = ledger "
        f"{vol:.0f} in {time.perf_counter() - t0:.1f} s")
    launches = dict(_build.launches)
    log("main", f"kernel launches on the main path: {launches}")
    for k in ("sat", "probe", "rectload"):
        check(launches.get(k, 0) > 0, f"kernel {k} never ran on the main path")

    # -- 7. times ----------------------------------------------------------
    def timed_plan_host(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planner.plan_host(rb, P=P, m=M, **kw)
        return (time.perf_counter() - t0) * 1e3

    timed_plan_host()
    runs = [timed_plan_host() for _ in range(5)]
    log("e2e", f"plan_host refinement-bursts T={T} heuristic: median "
        f"{statistics.median(runs):.1f} ms over 5 runs (min {min(runs):.1f}, "
        f"max {max(runs):.1f}); {T / statistics.median(runs) * 1e3:.1f} "
        f"frames/s")
    ex = timed_plan_host(exact=True)
    log("e2e", f"plan_host refinement-bursts T={T} exact: {ex:.1f} ms "
        f"(one run)")
    for size in (T, T // 4):
        firsts, alls = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            it = planner.plan_iter(rb, P=P, m=M, slice_size=size)
            next(it)
            firsts.append((time.perf_counter() - t0) * 1e3)
            for _ in it:
                pass
            alls.append((time.perf_counter() - t0) * 1e3)
        log("e2e", f"plan_iter refinement-bursts T={T} slice_size={size}: "
            f"first plan median {statistics.median(firsts):.1f} ms, all {T} "
            f"median {statistics.median(alls):.1f} ms over 3 runs")
    _, tim = planner.profile_stages(rb, P=P, m=M)
    log("e2e", "profile_stages heuristic: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in tim.items()))
    _, tim = planner.profile_stages(rb, P=P, m=M, exact=True)
    log("e2e", "profile_stages exact: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in tim.items()))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_plan_host()
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    n_launch = sum(e.count for e in dev_ev)
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:4]
    log("e2e", f"profiler, plan_host heuristic: {n_launch} device "
        f"operations, device busy {busy:.1f} ms of {wall:.1f} ms wall, "
        f"idle share {1 - busy / wall:.3f}; most time: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
            f"({e.count}x)" for e in top))

    kernels = []
    # K1 at the heuristic path's shape: (T, 512, 512) float32
    a = torch.as_tensor(rb, device=cuda).to(torch.float32)
    nbytes = a.numel() * 4 + T * (N1 + 1) * (N2 + 1) * 4
    b_ms, b_by = bound(nbytes, 2 * a.numel())
    kernels.append({
        "name": "sat", "route": "cuda",
        "source": "src/repro_torch/kernels/sat/sat.cu",
        "replaces": "src/repro/kernels/sat/sat.py:64",
        "launches": launches.get("sat", 0), "max_abs_err": err["sat"],
        "ms": device_ms(lambda: sat_ops.gamma(a)),
        "plain_ms": device_ms(lambda: sat_ref.gamma_ref(a)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda: torch.cumsum(torch.cumsum(
            a, dim=-2), dim=-1))})
    # K1 at plan_iter's slices: (T // 4, 512, 512) float32
    a16 = a[:T // 4].contiguous()
    nb16 = a16.numel() * 4 + (T // 4) * (N1 + 1) * (N2 + 1) * 4
    log("sat", f"K1 at plan_iter's slice shape {tuple(a16.shape)} float32: "
        f"{device_ms(lambda: sat_ops.gamma(a16)):.4f} ms against a bound of "
        f"{bound(nb16, 2 * a16.numel())[0]:.4f} ms ({nb16} bytes in and "
        f"out); at ({T}, {N1}, {N2}): {kernels[-1]['ms']:.4f} ms against "
        f"{b_ms:.4f} ms")
    log("sat", f"K1 at {tuple(a.shape)} float32 by kernel: "
        f"{by_kernel(lambda: sat_ops.gamma(a))}; {copy_rate(a)}")
    # K2 at the exact path's first column round: (T*P, 513) int32 stripe
    # rows, 8 interior candidates each, cap = Q
    g = torch.as_tensor(np.stack(host_gamma["refinement-bursts"]),
                        device=cuda).to(torch.int32)
    rc = torch.as_tensor(np.stack([pl.row_cuts for pl in plans[
        ("refinement-bursts", True)]]), device=cuda).long()
    tt = torch.arange(rc.shape[0], device=cuda)[:, None]
    sm = (g[tt, rc[:, 1:]] - g[tt, rc[:, :-1]]).reshape(-1, N2 + 1)
    los, his = device._exact_1d_bounds_int(sm, Q)
    j = torch.arange(1, 9, dtype=torch.int32, device=cuda)
    cand = device._interior_candidates(los[:, None], his[:, None], j[None],
                                       8).contiguous()
    counts = probe_ops.probe_counts(sm, cand, Q)
    err["probe"] = float((counts - probe_ref.probe_counts_ref(sm, cand, Q))
                         .abs().max())
    steps = int(torch.clamp(counts, max=Q).sum())   # greedy steps this run
    nbytes = sm.numel() * 4 + cand.numel() * 4 * 2
    b_ms, b_by = bound(nbytes, steps * (math.ceil(math.log2(N2 + 1)) + 2))
    kernels.append({
        "name": "probe", "route": "cuda",
        "source": "src/repro_torch/kernels/probe/probe.cu",
        "replaces": "src/repro/kernels/probe/probe.py:65",
        "launches": launches.get("probe", 0), "max_abs_err": err["probe"],
        "ms": device_ms(lambda: probe_ops.probe_counts(sm, cand, Q)),
        "plain_ms": device_ms(lambda: probe_ref.probe_counts_ref(
            sm, cand, Q)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    log("kernels", "probe: no single PyTorch call computes greedy interval "
        "counts (the plain version is a cap-step loop of gather + "
        "searchsorted), so library_ms is null")
    # the card's launch floor: the device time of one launch that does
    # next to nothing (a one-element add), queued as device_ms queues
    one = torch.zeros(1, device=cuda)
    floor_ms = device_ms(lambda: one.add_(1))
    log("kernels", f"launch floor: one one-element add_ takes {floor_ms:.4f} "
        f"ms (device_ms, queued launches; by kernel: "
        f"{by_kernel(lambda: one.add_(1))}); probe {kernels[-1]['ms']:.4f} "
        f"ms is {kernels[-1]['ms'] - floor_ms:.4f} ms above it, its bound "
        f"{b_ms:.4f} ms")
    log("probe", f"K2 at {tuple(sm.shape)} x {cand.shape[1]} candidates, "
        f"cap {Q}, one row and one warp a block, by kernel: "
        f"{by_kernel(lambda: probe_ops.probe_counts(sm, cand, Q))}")
    # where K2's time goes: its greedy steps, at the planner's rows and at
    # 4 rows alone (a few warps, so no walk waits for another's issue slot)
    sweep = {}
    for rows in (sm.shape[0], 4):
        ms0, ms1 = (device_ms(lambda c=c: probe_ops.probe_counts(
            sm[:rows], cand[:rows], c)) for c in (0, Q))
        sweep[rows] = f"{ms0:.4f} ms at cap 0, {ms1:.4f} ms at cap {Q}: " \
            f"{(ms1 - ms0) / Q * 1e3:.3f} us a step"
    log("probe", f"K2's steps: {sm.shape[0]} rows {sweep[sm.shape[0]]}; "
        f"4 rows alone {sweep[4]}")
    # K3 at the pricing shape: one plan, (P, m - P + 1) intervals
    pl = rb_plans[0]
    g1 = torch.from_numpy(host_gamma["refinement-bursts"][0].astype(
        np.float32)).to(cuda)
    rc1 = torch.as_tensor(pl.row_cuts, device=cuda).int()
    cc1 = torch.as_tensor(pl._live_col_cuts(), device=cuda).int()
    err["rectload"] = float((rl_ops.jagged_loads(g1, rc1, cc1)
                             - rl_ref.jagged_loads_ref(g1, rc1, cc1))
                            .abs().max())
    cc_np = pl._live_col_cuts()
    touched = touched_entries(pl.row_cuts, cc_np)
    n_rect = cc_np.shape[0] * (cc_np.shape[1] - 1)
    nbytes = touched * 4 + rc1.numel() * 4 + cc1.numel() * 4 + n_rect * 4
    b_ms, b_by = bound(nbytes, 3 * n_rect)
    kernels.append({
        "name": "rectload", "route": "cuda",
        "source": "src/repro_torch/kernels/rectload/rectload.cu",
        "replaces": "src/repro/kernels/rectload/rectload.py:55",
        "launches": launches.get("rectload", 0),
        "max_abs_err": err["rectload"],
        "ms": device_ms(lambda: rl_ops.jagged_loads(g1, rc1, cc1)),
        "plain_ms": device_ms(lambda: rl_ref.jagged_loads_ref(
            g1, rc1, cc1).to(torch.float32)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    log("kernels", "rectload: no single PyTorch call computes jagged "
        "rectangle loads (the plain version is two row gathers, one "
        "column gather and three differences), so library_ms is null")
    log("rectload", f"K3 one plan: {kernels[-1]['ms']:.4f} ms, "
        f"{kernels[-1]['ms'] - floor_ms:.4f} ms above the launch floor "
        f"({floor_ms:.4f} ms), bound {b_ms:.4f} ms; by kernel: "
        f"{by_kernel(lambda: rl_ops.jagged_loads(g1, rc1, cc1))}")
    run_rectload_stream(cuda, rb_plans, host_gamma["refinement-bursts"],
                        floor_ms)
    log("kernels", f"shapes: sat ({T}, {N1}, {N2}) float32; probe "
        f"{tuple(sm.shape)} int32 rows x 8 candidates, cap {Q}, {steps} "
        f"greedy steps; rectload one plan of {n_rect} intervals on a "
        f"({N1 + 1}, {N2 + 1}) float32 Gamma, {touched} distinct entries "
        f"touched; max_abs_err for sat is the largest over every "
        f"comparison above (float32 PIC frames lie above 2**24)")
    kernels.append(run_f64(cuda, streams, host_gamma, totals))
    run_runtime(cuda, streams, totals)
    run_serve()
    vols, g3, tot3 = volumes()
    k3, ratio32 = run_3d(cuda, vols, g3, tot3)
    kernels.extend(k3)
    kernels.append(run_f64_3d(cuda, vols, g3, tot3, ratio32))
    run_mesh(cuda, streams, totals, vols)
    run_dist()
    del vols, g3
    kernels.extend(run_registry(cuda))
    kernels.extend(run_flash(cuda))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
