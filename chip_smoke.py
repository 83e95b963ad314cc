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
``flash``, nothing else).  Then the general bf16 route
with its own launch counts: the same inputs, folded to ``(BH, S, d)`` and
copied one element past a 16-byte boundary, which TMA cannot describe,
through ``kernels.flash.ops.flash_attention`` (every shape through
``flash_general``, nothing else), held to the same limits.  The same
again at float16 (``flash_f16``, ``flash_f16_general``; rtol = atol =
5e-3, relative L2 2.5e-3).  The Gemma-2 queries are drawn large enough
that the softcap changes the logits; ``flex_attention`` (compiled) is
timed there as the library yardstick at each dtype, SDPA at Qwen3.  Then
one float32 check at Qwen3 width and S=2048 (2e-5, relative L2 1e-5)
with its own launch count (``flash_f32``, the 3xTF32 kernel), SDPA on
float32 beside it.
Then the wide routes (d > 256) at DeepSeek-V2-236B's absorbed MLA
width, d = 576, causal, Sq = Skv = 4096, 16 of its 128 heads (a cut), at
float32, bfloat16 and float16: one launch each of ``flash_wide`` (S once
a key tile for every output column), then the same inputs copied one
element past a 16-byte boundary, which TMA cannot describe: three
launches each of ``flash_realign`` (the copy of each into padded,
aligned scratch, timed beside its byte bound) and one of ``flash_wide``;
the same at d = 569 (d % 8 != 0): four ``flash_realign`` launches, the
output padded and cut back (the unpad timed beside its byte bound), and
one ``flash_wide``; then past ``flash_wide``'s widest head (576) the
cluster kernel, (4, 1024, 640) and (16, 4096, 1024) causal, one launch
each of ``flash_wide_cluster`` (a query tile on a cluster of 2 blocks,
each owning a share of d), and (4, 1024, 1030) on copies one element
past a 16-byte boundary, four ``flash_realign`` launches and one
``flash_wide_cluster`` (3 blocks); then (2, 512, 4160) causal, past the
cluster's widest (4096), one launch each of ``flash_wide_general``; each held to
the plain version at its dtype's limits and timed beside SDPA at that
dtype (the backend it picks named).  Then the decoder-only model path
(``run_models``)
with its own launch counts: Qwen3-0.6B at full width in bf16, through
``models.api``, serving two groups of ``serve.batcher.plan``'s replicas
(left-padded prompts, prefill and greedy decode steps) with times beside
their bounds, the card's idle share and peak memory; the card against
the CPU at float32 (Qwen3-0.6B, and every dense and VLM smoke config)
and teacher forcing at full width (Qwen3-0.6B; gemma2-9b's first two
layers past its window), each within 1e-4 x max |logits|; and no launch
of K1-K5, as the reference's models call the plain chunked attention.
Then the MoE and MLA path (``run_moe``) with its own launch counts:
Mixtral-8x7B (4 of 32 layers) and DeepSeek-V2-236B (2 of 60) at full
width in bf16 serving two of the same replica groups, each padded to a
length the MoE's dispatch groups take (P15), with times beside their
bounds (operations counted by ``FlopCounterMode``), idle shares and peak
memory; the card against the CPU at float32 (both smoke models;
Mixtral's ``moe_forward`` and DeepSeek's ``mla_forward``, prefill and
absorbed decode, at full width), the experts chosen and their capacity
slots first (a flip only at a near tie, 1e-6 relative); teacher forcing
at full width on one layer of each; no launch of K1-K5.  Then the SSM,
hybrid and encoder-decoder path (``run_ssm_encdec``) with its own launch
counts: Mamba2-1.3B, Hymba-1.5B and Whisper-large-v3 at full width and
full depth in bf16 serving the same two groups as ``run_models`` (SSD
chunks of the largest divisor of S not above ``ssm_chunk``; Whisper on
seeded stub frames), with times beside their bounds (operations by
dtype: the SSD scan's float32 contractions over the float32 rate), idle
shares and peak memory; the card against the CPU at float32 (the three
smoke models and each model cut to 2 layers at full width: the
whole-sequence logits, prefill, two decode steps and every cache tensor,
the SSM's state and conv tail and Whisper's encoder states included);
teacher forcing on the same cut (prefill on 192 tokens, then 4 decode
steps against the whole sequence); no launch of K1-K5.  Then training
(``run_train``) with its own launch counts: Qwen3-0.6B at full width and
full depth in bf16 (float32 moments) through ``launch.train.main``, 6
steps at B=8, S=512 with a checkpoint every 3; the last checkpoint
restored on the card bit for bit; with it uncommitted, a second call
resumes from step 3, its losses within 2e-2 of the first call's; step
time, tokens/s, kernels a step, idle share, peak memory and the
operations' bound; one float32 step at full width on the card against
the CPU; the smoke config's loss falling by more than 0.5 in 30 steps;
no launch of K1-K5.  Last, the sharded steps (``run_sharded``) with
their own launch counts: Qwen3-0.6B whole in bf16 (float32 moments) takes
3 train steps at B=8, S=512 through ``launch.steps.build_train`` on
``launch.mesh.make_local_mesh()``, every parameter, moment and metric
``torch.equal`` to ``make_train_step`` without a mesh from the same
start, ms a step for both; Qwen3 prefills (B=8, 192 tokens) and takes 8
decode steps through ``build_prefill``/``build_decode`` on the local mesh
and on a (2, 2) ``("data", "model")`` mesh that names the card four times
(the chunked attention's head-sharded branch), and DeepSeek-V2-236B (2
of 60 layers) and Whisper-large-v3 (2 layers) at full width prefill and
take 2 decode steps on the (2, 2) mesh, the logits of every call and
every cache tensor ``torch.equal`` to ``models.api`` without a mesh (run
first and last, times beside the meshes'); one dry-run cell
(``dryrun.run_cell("qwen3-0.6b", "decode_32k")``, on ``meta``) with its
roofline's dominant term and wall time; no launch of K1-K5.

Dtype contract checked here: int32 results are bit-identical between the
kernels and the plain versions, and to the CPU path; so are float32
results where every frame total is below 2**24.  Above it (the PIC
series reaches 5.2e8) float32 sums may be taken in another order: Gamma
is held to 1e-6 of the frame total against the exact int64 prefix, Lmax
to a relative 1e-2 against the CPU path, and the cuts may differ.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
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
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
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
    from repro_torch.kernels.probe.compare import walk_steps
    n = N_1D[-1]
    key = ((1, n + 1), "int32", 15, M)
    p, cand, counts = k2_calls[key][0]      # the solver's first round
    steps = int(torch.clamp(counts, max=M).sum())
    longest = int(walk_steps(p, cand, M).max())   # the walks' longest chain
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
        f"{steps} greedy steps, one warp a walk, the longest walk {longest} "
        f"steps: {entry['ms']:.4f} ms on {card_line()} "
        f"({entry['ms'] * 1e3 / longest:.3f} us a step of the longest walk) "
        f"against a bound of {b_ms:.4f} ms ({b_by}); plain version "
        f"{entry['plain_ms']:.4f} ms; the solver's 5 rounds "
        f"(nicol_optimal_device_impl n={n}) "
        f"{secs[f'nicol_optimal_device_impl n={n}'] * 1e3:.1f} ms on the "
        f"host clock")
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
#: K5's limits by dtype, compared in float32: elementwise (rtol = atol) and
#: relative L2; float16's is about two float16 ulps at the outputs' size
FLASH_LIMITS = {torch.float32: (2e-5, 1e-5),
                torch.bfloat16: (2e-2, 1e-2),
                torch.float16: (5e-3, 2.5e-3)}
# K5's wide route at DeepSeek-V2-236B's absorbed MLA width: attention over
# the latent keys, kv_lora_rank 512 + qk_rope_dim 64 wide
# (src/repro/configs/deepseek_v2_236b.py), causal, Sq = Skv = 4096, 16 of
# its 128 heads (a cut)
WIDE_SRC = "src/repro/configs/deepseek_v2_236b.py"
WIDE_D, WIDE_S, WIDE_H, WIDE_H_FULL = 576, 4096, 16, 128
# the cluster kernel's shapes (flash_wide_cluster, 576 < d <= 4096): d 640
# (two blocks a query tile) at a quarter of the heads and of the length
# above, d 1024 (two blocks) at the heads and length above; and d 1030 (d
# % 8 != 0, three blocks) at the first shape on bases one element past a
# 16-byte boundary, realigned; no config has such a head
WIDE_C_SHAPES = [((4, 1024, 640), "d 640"), ((16, 4096, 1024), "d 1024")]
WIDE_C_U_SHAPE = (4, 1024, 1030)
# the general wide kernel's shape: a head past the cluster's widest (4096)
WIDE_G_SHAPE, WIDE_G_NAME = (2, 512, 4160), "d 4160 (past 4096)"
# a head with d % 8 != 0 on the realigned route, at the shape above: the
# output is padded and cut back (unpad); rows of 569 elements start at
# every element offset within a 16-byte segment, and at float32 the last
# 16 bytes of each padded row lie wholly past d (zeroed)
WIDE_U_D = 569


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


def sdpa_backend(q4, k4, v4) -> str:
    """The backend SDPA picks for these inputs, causal
    (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend
    names = {m.value: n for n, m in SDPBackend.__members__.items()}
    return names[torch._fused_sdp_choice(q4, k4, v4, is_causal=True)]


def within_limits(name: str, got: torch.Tensor, want: torch.Tensor,
         dtype: torch.dtype) -> tuple[float, float]:
    """max |got - want| and relative L2 in float32, both checked at
    ``dtype``'s limits (``FLASH_LIMITS``)."""
    tol, rel_max = FLASH_LIMITS[dtype]
    got, want = got.float(), want.float()
    e = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    check(torch.allclose(got, want, rtol=tol, atol=tol), f"flash {name}: "
          f"kernel is {e:.3g} off the plain version (limit rtol = atol = "
          f"{tol})")
    check(rel <= rel_max, f"flash {name}: kernel's relative L2 error "
          f"{rel:.3g} (limit {rel_max})")
    return e, rel


def wide_sdpa(q, k, v, want) -> tuple:
    """SDPA (``is_causal``) on folded ``(BH, S, d)`` inputs: its time where
    its result is within the dtype's relative L2 of the plain version's
    ``want`` (else None), the backend it picks, and that relative L2."""
    def sdpa(q4=q[None], k4=k[None], v4=v[None]):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)[0]
    rel = float((sdpa().float() - want).norm() / want.norm())
    ok = rel <= FLASH_LIMITS[q.dtype][1]
    return (device_ms(sdpa) if ok else None,
            sdpa_backend(q[None], k[None], v[None]), rel)


def wide_bound(q, ops: float) -> tuple:
    """K5's bound for ``ops`` operations on q, k, v and out like ``q``:
    3xTF32 (three tensor-core passes) at float32, the 16-bit tensor-core
    rate otherwise; with the bytes."""
    nbytes = 4 * q.numel() * q.element_size()
    if q.dtype == torch.float32:
        return (*bound(nbytes, 3 * ops, TF32_OPS_PER_S), nbytes)
    return (*bound(nbytes, ops, BF16_TC_OPS_PER_S), nbytes)


def run_flash_wide(cuda: torch.device, normal) -> list:
    """K5's wide routes (d > 256) at DeepSeek-V2's absorbed MLA width: q,
    k, v of (16, 4096, 576), causal, at float32, bfloat16 and float16,
    each through ``ops.flash_attention`` with its own launch count (one
    ``flash_wide`` launch, nothing else), then the same inputs copied one
    element past a 16-byte boundary with their own (three ``flash_realign``
    launches, one a tensor, and one ``flash_wide``), the copy alone timed
    beside its byte bound and held bit for bit to its plain version, and
    at d % 8 != 0 (``run_flash_wide_unpadded``); then heads past 576 on
    the cluster kernel (``run_flash_wide_cluster``) and past 4096
    (``WIDE_G_SHAPE``), one ``flash_wide_general`` launch a dtype.  Each
    output held to the plain version at its dtype's limits and timed
    beside its bound, the plain version and SDPA at that dtype (the
    backend it picks named).  Returns the entries ``flash_wide``,
    ``flash_realign``, ``flash_wide_cluster`` and ``flash_wide_general``
    of the kernels' record (top-level numbers at bfloat16; every dtype's
    under ``shapes``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._compare import unaligned
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    t_phase = time.perf_counter()
    log("wide", f"DeepSeek-V2-236B absorbed attention ({WIDE_SRC}): d "
        f"{WIDE_D} (kv_lora_rank 512 + qk_rope_dim 64), causal, Sq = Skv = "
        f"{WIDE_S}; cut: {WIDE_H} of its {WIDE_H_FULL} heads")

    ops = 4 * WIDE_H * WIDE_D * causal_pairs(WIDE_S, 0)
    rows, urows, crows, n, cn = [], [], [], 0, 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype)[6:]
        q, k, v = (normal((WIDE_H, WIDE_S, WIDE_D), torch.float32).to(dtype)
                   for _ in range(3))
        _build.launches.clear()
        out = flash_ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        check(launches == {"flash_wide": 1}, f"flash wide {dtype}: "
              f"launches {launches}, not one flash_wide and nothing else")
        # the same inputs at bases TMA cannot describe: realigned into
        # padded, aligned scratch, then flash_wide
        general = tuple(unaligned(x) for x in (q, k, v))
        check(all(x.data_ptr() % 16 != 0 for x in general),
              "flash wide: the unaligned copies lie on 16-byte boundaries")
        _build.launches.clear()
        uout = flash_ops.flash_attention(*general, causal=True)
        torch.cuda.synchronize()
        ulaunches = dict(_build.launches)
        check(ulaunches == {"flash_realign": 3, "flash_wide": 1},
              f"flash wide {dtype} at unaligned bases: launches "
              f"{ulaunches}, not three flash_realign and one flash_wide")
        n += launches["flash_wide"] + ulaunches["flash_wide"]
        cn += ulaunches["flash_realign"]
        for name, x in (("flash_wide", out), ("realigned", uout)):
            check(x.shape == q.shape and x.dtype == dtype
                  and bool(torch.isfinite(x).all()), f"{name} {dtype}: "
                  f"output is not finite {dtype} of shape {tuple(q.shape)}")
        want = flash_ref.attention_ref(q, k, v, causal=True).float()
        e, rel = within_limits(f"wide {dtype}", out, want, dtype)
        ue, urel = within_limits(f"wide realigned {dtype}", uout, want,
                                 dtype)
        b_ms, b_by, nbytes = wide_bound(q, ops)
        lib_ms, backend, lib_rel = wide_sdpa(q, k, v, want)
        row = {"shape": f"deepseek-v2 absorbed {dname}",
               "source": WIDE_SRC, "dtype": dname, "BH": WIDE_H,
               "S": WIDE_S, "d": WIDE_D, "window": 0, "softcap": 0.0,
               "max_abs_err": e, "rel_l2_err": rel,
               "ms": device_ms(lambda: flash_ops.flash_attention(
                   q, k, v, causal=True)),
               "plain_ms": device_ms(lambda: flash_ref.attention_ref(
                   q, k, v, causal=True), reps=3),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "library": backend}
        log("wide", f"{row['shape']} (BH {WIDE_H}, {WIDE_S}, {WIDE_D}): "
            f"max |kernel - plain| {e:.3g}, relative L2 {rel:.3g} (limits "
            f"{FLASH_LIMITS[dtype]}); ms {row['ms']:.4f}, plain_ms "
            f"{row['plain_ms']:.4f}, bound_ms {b_ms:.4f} ({b_by}; {ops} "
            f"operations{', x3 over TF32' if dtype == torch.float32 else ''}"
            f", {nbytes} bytes); library_ms {lib_ms} (SDPA, is_causal, "
            f"backend {backend}; relative L2 {lib_rel:.3g} off the plain "
            f"version" + ("" if lib_ms is not None else ": above the limit, "
                          "so not timed as this function") + ")")
        # the copy alone, one tensor: its bytes read once and written once
        x0 = general[0]
        got = flash_ops.pad8(x0)
        check(torch.equal(got.view(torch.uint8),
                          flash_ref.pad8_ref(x0).view(torch.uint8)),
              f"flash_realign {dtype}: the copy differs from its plain "
              f"version")
        cbytes = x0.numel() * x0.element_size() + got.numel() * \
            got.element_size()
        c_ms, c_by = bound(cbytes, 0)
        crow = {"shape": f"deepseek-v2 absorbed {dname}, one tensor",
                "dtype": dname, "BH": WIDE_H, "S": WIDE_S, "d": WIDE_D,
                "offset_bytes": x0.data_ptr() % 16, "max_abs_err": 0.0,
                "ms": device_ms(lambda: flash_ops.pad8(x0)),
                "plain_ms": device_ms(lambda: flash_ref.pad8_ref(x0)),
                "bound_ms": c_ms, "bound_by": c_by,
                "library_ms": device_ms(
                    lambda: torch.nn.functional.pad(x0, (0, 0))),
                "bytes": cbytes}
        urow = dict(row, shape=f"deepseek-v2 absorbed {dname}, unaligned "
                    f"bases: flash_realign x3 + flash_wide",
                    max_abs_err=ue, rel_l2_err=urel,
                    ms=device_ms(lambda: flash_ops.flash_attention(
                        *general, causal=True)))
        log("wide", f"{crow['shape']}: flash_realign (bases "
            f"{crow['offset_bytes']} bytes past 16) {crow['ms']:.4f} ms "
            f"against its bound {c_ms:.4f} ms ({cbytes} bytes over "
            f"{HBM_BYTES_PER_S:.3g} B/s: {c_ms / crow['ms']:.1%} of it), "
            f"bit for bit its plain version (plain_ms {crow['plain_ms']:.4f}"
            f"; library_ms {crow['library_ms']:.4f}: "
            f"torch.nn.functional.pad, the plain version's call); three "
            f"copies a call, bound {3 * c_ms:.4f} ms")
        log("wide", f"{row['shape']} unaligned route (flash_realign x3 + "
            f"flash_wide on the scratch): max |kernel - plain| {ue:.3g}, "
            f"relative L2 {urel:.3g}; ms {urow['ms']:.4f} = flash_wide on "
            f"aligned inputs {row['ms']:.4f} + {urow['ms'] - row['ms']:.4f}"
            f" (three copies alone {3 * crow['ms']:.4f})")
        rows.append(row)
        urows.append(urow)
        crows.append(crow)
        del q, k, v, out, uout, general, want, got, x0
        prow, pcrow = run_flash_wide_unpadded(normal, dtype)
        urows.append(prow)
        crows.append(pcrow)
        n += 1
        cn += 4
    torch.cuda.empty_cache()
    clrows, cln, ccn = run_flash_wide_cluster(normal)
    cn += ccn
    torch.cuda.empty_cache()
    grows = run_flash_wide_general(normal)
    log("wide", f"the wide phase took {time.perf_counter() - t_phase:.1f} s")
    top = "deepseek-v2 absorbed bfloat16"
    return [flash_entry("flash_wide", n, max(r["max_abs_err"]
                                             for r in rows + urows),
                        rows + urows, top),
            flash_entry("flash_realign", cn, 0.0, crows, f"{top}, one tensor",
                        source="src/repro_torch/kernels/flash/realign.cu"),
            flash_entry("flash_wide_cluster", cln,
                        max(r["max_abs_err"] for r in clrows), clrows,
                        "d 1024 bfloat16"),
            flash_entry("flash_wide_general", len(grows),
                        max(r["max_abs_err"] for r in grows), grows,
                        f"{WIDE_G_NAME} bfloat16")]


def run_flash_wide_unpadded(normal, dtype: torch.dtype) -> tuple:
    """The realigned route where d % 8 != 0: (``WIDE_H``, ``WIDE_S``,
    ``WIDE_U_D``) causal on copies one element past a 16-byte boundary,
    four ``flash_realign`` launches (q, k and v padded, the output cut
    back) and one ``flash_wide``, the output held to the plain version at
    ``dtype``'s limits and timed beside its bound, the plain version and
    SDPA; then the two copies alone on one tensor, each held bit for bit
    to its plain version, and the unpad timed beside its byte bound.
    Returns the route's row and the unpad's row of the kernels' record."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._compare import unaligned
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    d, dname = WIDE_U_D, str(dtype)[6:]
    q, k, v = (normal((WIDE_H, WIDE_S, d), torch.float32).to(dtype)
               for _ in range(3))
    general = tuple(unaligned(x) for x in (q, k, v))
    check(all(x.data_ptr() % 16 != 0 for x in general),
          "flash wide: the unaligned copies lie on 16-byte boundaries")
    _build.launches.clear()
    out = flash_ops.flash_attention(*general, causal=True)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    check(launches == {"flash_realign": 4, "flash_wide": 1},
          f"flash wide {dtype} at d {d}, unaligned bases: launches "
          f"{launches}, not four flash_realign and one flash_wide")
    check(out.shape == q.shape and out.dtype == dtype
          and bool(torch.isfinite(out).all()), f"realigned {dtype} d {d}: "
          f"output is not finite {dtype} of shape {tuple(q.shape)}")
    want = flash_ref.attention_ref(q, k, v, causal=True).float()
    e, rel = within_limits(f"wide realigned {dtype} d {d}", out, want, dtype)
    ops = 4 * WIDE_H * d * causal_pairs(WIDE_S, 0)
    b_ms, b_by, nbytes = wide_bound(q, ops)
    lib_ms, backend, lib_rel = wide_sdpa(q, k, v, want)
    row = {"shape": f"deepseek-v2 absorbed {dname}, d {d}, unaligned "
           f"bases: flash_realign x4 + flash_wide", "source": WIDE_SRC,
           "dtype": dname, "BH": WIDE_H, "S": WIDE_S, "d": d, "window": 0,
           "softcap": 0.0, "max_abs_err": e, "rel_l2_err": rel,
           "ms": device_ms(lambda: flash_ops.flash_attention(
               *general, causal=True)),
           "plain_ms": device_ms(lambda: flash_ref.attention_ref(
               q, k, v, causal=True), reps=3),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "library": backend}
    log("wide", f"{row['shape']} (BH {WIDE_H}, {WIDE_S}, {d}): max |kernel "
        f"- plain| {e:.3g}, relative L2 {rel:.3g}; ms {row['ms']:.4f}, "
        f"plain_ms {row['plain_ms']:.4f}, bound_ms {b_ms:.4f} ({b_by}; "
        f"{nbytes} bytes); library_ms {lib_ms} (SDPA, backend {backend}; "
        f"relative L2 {lib_rel:.3g} off the plain version"
        + ("" if lib_ms is not None else ": above the limit, so not timed "
           "as this function") + ")")
    # the copies alone on one tensor: pad (at float32 with units wholly
    # past d), then unpad of its result (rows at every element offset)
    x0 = general[0]
    p = flash_ops.pad8(x0)
    check(torch.equal(p.view(torch.uint8),
                      flash_ref.pad8_ref(x0).view(torch.uint8)),
          f"flash_realign {dtype} d {d}: the pad differs from its plain "
          f"version")
    got = flash_ops.unpad8(p, d)
    check(torch.equal(got.view(torch.uint8),
                      flash_ref.unpad8_ref(p, d).view(torch.uint8)),
          f"flash_realign {dtype} d {d}: the unpad differs from its plain "
          f"version")
    cbytes = (p.numel() + got.numel()) * p.element_size()
    c_ms, c_by = bound(cbytes, 0)
    crow = {"shape": f"deepseek-v2 absorbed {dname}, d {d}, unpad, one "
            f"tensor", "dtype": dname, "BH": WIDE_H, "S": WIDE_S, "d": d,
            "offset_bytes": got.data_ptr() % 16, "max_abs_err": 0.0,
            "ms": device_ms(lambda: flash_ops.unpad8(p, d)),
            "plain_ms": device_ms(lambda: flash_ref.unpad8_ref(p, d)),
            "bound_ms": c_ms, "bound_by": c_by,
            "library_ms": device_ms(lambda: p[..., :d].contiguous()),
            "bytes": cbytes}
    log("wide", f"{crow['shape']}: flash_realign unpad ({tuple(p.shape)} -> "
        f"{tuple(got.shape)}) {crow['ms']:.4f} ms against its bound "
        f"{c_ms:.4f} ms ({cbytes} bytes over {HBM_BYTES_PER_S:.3g} B/s: "
        f"{c_ms / crow['ms']:.1%} of it), bit for bit its plain version, "
        f"as the pad is (plain_ms {crow['plain_ms']:.4f}; library_ms "
        f"{crow['library_ms']:.4f}: the slice made contiguous, the plain "
        f"version's call); the route {row['ms']:.4f} ms")
    del q, k, v, general, out, want, p, got, x0
    return row, crow


def wide_row(name: str, shape: tuple, dtype: torch.dtype, out, want,
             ops: float, call, plain, q, k, v) -> dict:
    """One wide route's row of the kernels' record: ``out`` held to the
    plain version's ``want`` at ``dtype``'s limits, ``call`` timed beside
    ``plain``, the bound of ``ops`` operations on q, k, v and out (the
    inputs' bytes) and SDPA on q, k, v (its backend named)."""
    BH, S, d = shape
    check(out.shape == shape and out.dtype == dtype
          and bool(torch.isfinite(out).all()), f"{name}: output is not "
          f"finite {dtype} of shape {shape}")
    e, rel = within_limits(name, out, want, dtype)
    b_ms, b_by, nbytes = wide_bound(q, ops)
    lib_ms, backend, lib_rel = wide_sdpa(q, k, v, want)
    row = {"shape": name, "dtype": str(dtype)[6:], "BH": BH, "S": S,
           "d": d, "window": 0, "softcap": 0.0, "max_abs_err": e,
           "rel_l2_err": rel, "ms": device_ms(call),
           "plain_ms": device_ms(plain, reps=3), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms, "library": backend}
    log("wide", f"{name} {shape} causal: max |kernel - plain| {e:.3g}, "
        f"relative L2 {rel:.3g} (limits {FLASH_LIMITS[dtype]}); ms "
        f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, bound_ms "
        f"{b_ms:.4f} ({b_by}; {ops} operations"
        f"{', x3 over TF32' if dtype == torch.float32 else ''}, {nbytes} "
        f"bytes); library_ms {lib_ms} (SDPA, is_causal, backend {backend}; "
        f"relative L2 {lib_rel:.3g} off the plain version"
        + ("" if lib_ms is not None else ": above the limit, so not timed "
           "as this function") + ")"
        + (f"; {row['ms'] / lib_ms:.3f}x SDPA's time" if lib_ms else ""))
    return row


def run_flash_wide_cluster(normal) -> tuple:
    """The cluster kernel (``flash_wide_cluster``: a query tile on a
    cluster of blocks, each owning a share of d, S summed once through
    distributed shared memory) at ``WIDE_C_SHAPES`` causal at float32,
    bfloat16 and float16, one launch each and nothing else; then at
    ``WIDE_C_U_SHAPE`` on copies one element past a 16-byte boundary, four
    ``flash_realign`` launches (q, k, v padded to 1032, the output cut
    back) and one ``flash_wide_cluster``.  Each held to the plain version
    at its dtype's limits and timed beside its bound, the plain version
    and SDPA.  Returns its rows, its launches and the copies'."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._compare import unaligned
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    rows, n, cn = [], 0, 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype)[6:]
        for shape, sname in WIDE_C_SHAPES + [(WIDE_C_U_SHAPE, None)]:
            BH, S, d = shape
            q, k, v = (normal(shape, torch.float32).to(dtype)
                       for _ in range(3))
            xs = (q, k, v)
            want_launches = {"flash_wide_cluster": 1}
            if sname is None:   # the realigned route, d % 8 != 0
                xs = tuple(unaligned(x) for x in xs)
                check(all(x.data_ptr() % 16 != 0 for x in xs),
                      "flash wide cluster: the unaligned copies lie on "
                      "16-byte boundaries")
                want_launches["flash_realign"] = 4
                sname = f"d {d}, unaligned bases: flash_realign x4 + " \
                    f"flash_wide_cluster"
            flash_ops.cluster_blocks_seen()   # clears the record
            _build.launches.clear()
            out = flash_ops.flash_attention(*xs, causal=True)
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            check(launches == want_launches, f"flash wide cluster {dtype} "
                  f"at {shape}: launches {launches}, not {want_launches}")
            # the cluster size the launch ran with, as its kernel read it
            # from %cluster_nctarank, beside flash.cu's own launch rule
            blocks = flash_ops.cluster_blocks_seen()
            rule = flash_ops.cluster_blocks(flash_ops.padded(d),
                                            q.element_size())
            check(blocks >= 2 and blocks == rule, f"flash wide cluster at "
                  f"d {d}: the kernel ran on clusters of {blocks} blocks "
                  f"(flash.cu's rule: {rule})")
            n += launches["flash_wide_cluster"]
            cn += launches.get("flash_realign", 0)
            want = flash_ref.attention_ref(q, k, v, causal=True).float()
            row = wide_row(
                f"{sname} {dname}", shape, dtype, out, want,
                4 * BH * d * causal_pairs(S, 0),
                lambda xs=xs: flash_ops.flash_attention(*xs, causal=True),
                lambda: flash_ref.attention_ref(q, k, v, causal=True),
                q, k, v)
            row["blocks_a_cluster"] = blocks
            log("wide", f"{row['shape']}: clusters of {blocks} blocks, "
                f"read in the kernel (%cluster_nctarank)")
            rows.append(row)
            del q, k, v, xs, out, want
    return rows, n, cn


def run_flash_wide_general(normal) -> list:
    """The general wide kernel where the wrapper sends it: a head past
    ``flash_wide_cluster``'s widest, ``WIDE_G_SHAPE`` causal at float32,
    bfloat16 and float16, one ``flash_wide_general`` launch each and
    nothing else, held to the plain version and timed beside its bound,
    the plain version and SDPA.  Returns its rows of the kernels'
    record."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    BH, S, d = WIDE_G_SHAPE
    grows = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = (normal(WIDE_G_SHAPE, torch.float32).to(dtype)
                   for _ in range(3))
        _build.launches.clear()
        out = flash_ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        check(launches == {"flash_wide_general": 1}, f"flash wide general "
              f"{dtype} at d {d}: launches {launches}, not one "
              f"flash_wide_general and nothing else")
        want = flash_ref.attention_ref(q, k, v, causal=True).float()
        grows.append(wide_row(
            f"{WIDE_G_NAME} {str(dtype)[6:]}", WIDE_G_SHAPE, dtype, out, want,
            4 * BH * d * causal_pairs(S, 0),
            lambda: flash_ops.flash_attention(q, k, v, causal=True),
            lambda: flash_ref.attention_ref(q, k, v, causal=True), q, k, v))
        del q, k, v, out, want
    return grows


def flash_entry(name: str, n: int, e: float, shape_rows: list, top: str,
                source: str = "src/repro_torch/kernels/flash/flash.cu"
                ) -> dict:
    """One K5 route's entry of the kernels' record: the top-level numbers
    from the row of shape ``top``, every row under ``shapes``."""
    top = next(r for r in shape_rows if r["shape"] == top)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/flash/flash.py:94",
        "launches": n, "max_abs_err": e,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shapes": shape_rows}


def run_flash_16(normal, dtype: torch.dtype, key: str, gkey: str) -> list:
    """K5 at a 16-bit ``dtype`` on ``FLASH_SHAPES``: ``ops.attention`` on
    the aligned inputs with its own launch counts (the Hopper kernel, one
    launch of ``key`` a shape and nothing else), then the same inputs,
    folded and copied to unaligned bases, through ``ops.flash_attention``
    with their own (the general kernel, ``gkey``), each output held to
    the plain version at ``dtype``'s limits, and times beside the bound,
    the plain version and the library yardstick (compiled
    ``flex_attention`` under the softcap, SDPA elsewhere).  Returns the
    entries ``key`` and ``gkey`` of the kernels' record (top-level
    numbers at the Qwen3 shape; every shape's under ``shapes``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._compare import unaligned
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    tag, dname = ("flash" if dtype == torch.bfloat16 else "flash16",
                  str(dtype)[6:])
    tol, rel_max = FLASH_LIMITS[dtype]
    # -- data: random q, k, v from a seed, on the card --------------------
    # Where there is a softcap, q has standard deviation Q_STD_SOFTCAP, so
    # the logits spread as far (the largest reach about 50) and the softcap
    # changes them; elsewhere q, k and v are unit normals.
    inputs = {}
    for name, _, H, Hkv, d, _, softcap in FLASH_SHAPES:
        q = normal((1, S_FLASH, H, d), torch.float32)
        q = (q * (Q_STD_SOFTCAP if softcap else 1.0)).to(dtype)
        k, v = (layers.repeat_kv(normal((1, S_FLASH, Hkv, d), dtype),
                                 H // Hkv) for _ in range(2))
        inputs[name] = (q, k, v)

    # -- the attention path at full width ---------------------------------
    _build.launches.clear()
    outs = {}
    t0 = time.perf_counter()
    for name, _, H, _, d, window, softcap in FLASH_SHAPES:
        outs[name] = flash_ops.attention(*inputs[name], causal=True,
                                         window=window, softcap=softcap)
    torch.cuda.synchronize()
    log(tag, f"{dname} attention on the 3 shapes in "
        f"{time.perf_counter() - t0:.2f} s (host clock, first calls)")
    launches = dict(_build.launches)
    log(tag, f"kernel launches on the {dname} attention path: {launches}")
    check(launches == {key: len(FLASH_SHAPES)}, f"the {dname} attention "
          f"path did not take the Hopper kernel ({key}) once a shape and "
          f"nothing else")

    def fold(x):
        return x.transpose(1, 2).reshape(-1, S_FLASH,
                                         x.shape[-1]).contiguous()

    # -- the general route at full width ----------------------------------
    # The same inputs, folded, at bases TMA cannot describe: the C entry
    # point gives every shape to the general kernel (the Hopper kernel's
    # wgmma consumers behind a producer of threads).
    general = {name: tuple(unaligned(fold(x)) for x in inputs[name])
               for name, *_ in FLASH_SHAPES}
    check(all(x.data_ptr() % 16 != 0 for g in general.values() for x in g),
          f"flash {dname}: the unaligned copies lie on 16-byte boundaries")
    _build.launches.clear()
    gouts = {}
    for name, _, _, _, _, window, softcap in FLASH_SHAPES:
        gouts[name] = flash_ops.flash_attention(
            *general[name], causal=True, window=window, softcap=softcap)
    torch.cuda.synchronize()
    glaunches = dict(_build.launches)
    log(tag, f"kernel launches on the {dname} general route (unaligned "
        f"bases): {glaunches}")
    check(glaunches == {gkey: len(FLASH_SHAPES)}, f"the unaligned {dname} "
          f"inputs did not take the general kernel ({gkey}) once a shape "
          f"and nothing else")

    def rel_l2(got, want):
        return float((got - want).norm() / want.norm())

    rows, grows, err, gerr = [], [], 0.0, 0.0
    for name, src, H, Hkv, d, window, softcap in FLASH_SHAPES:
        q, k, v = inputs[name]
        out = outs[name]
        check(out.shape == (1, S_FLASH, H, d) and out.dtype == dtype
              and bool(torch.isfinite(out).all()),
              f"flash {name} ({key}): output is not finite {dname} of "
              f"shape {(1, S_FLASH, H, d)}")
        qf, kf, vf = fold(q), fold(k), fold(v)
        kw = dict(causal=True, window=window, softcap=softcap)
        want = flash_ref.attention_ref(qf, kf, vf, **kw).float()
        got = fold(out).float()
        e, rel = within_limits(f"{name} ({key})", got, want, dtype)
        gout = gouts[name]
        check(gout.shape == qf.shape and gout.dtype == dtype
              and bool(torch.isfinite(gout).all()),
              f"flash {name} ({gkey}): output is not finite {dname} of "
              f"shape {tuple(qf.shape)}")
        ge, grel = within_limits(f"{name} ({gkey})", gout, want, dtype)
        held = (f"max |kernel - plain| {e:.3g} (held at rtol = atol = "
                f"{tol}), relative L2 {rel:.3g} (limit {rel_max}; |plain| "
                f"median {float(want.abs().median()):.3g}, max "
                f"{float(want.abs().max()):.3g})")
        if softcap:
            # the data is such that a kernel ignoring the softcap would fail
            nocap = flash_ref.attention_ref(qf, kf, vf, causal=True,
                                            window=window).float()
            rel_nocap = rel_l2(nocap, want)
            del nocap
            check(rel_nocap > rel_max, f"flash {name} {dname}: without the "
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
               "softcap": softcap, "dtype": dname, "max_abs_err": e,
               "rel_l2_err": rel,
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
            lib_name = (f"SDPA, is_causal, backend "
                        f"{sdpa_backend(qf[None], kf[None], vf[None])}")
        lib_out = lib_fn().float()
        lib_rel = rel_l2(lib_out, want)
        lib_err = float((lib_out - got).abs().max())
        del lib_out, want, got
        check(lib_rel <= rel_max, f"flash {name} {dname}: the library "
              f"yardstick ({lib_name}) is {lib_rel:.3g} off the plain "
              f"version (relative L2): it does not compute this function")
        row["library_ms"] = device_ms(lib_fn)
        lib = (f"library_ms {row['library_ms']:.4f} ({lib_name} at "
               f"{dname}; a yardstick only: relative L2 {lib_rel:.3g} off "
               f"the plain version, max |library - kernel| {lib_err:.3g})")
        grow = dict(row, max_abs_err=ge, rel_l2_err=grel,
                    ms=device_ms(lambda: flash_ops.flash_attention(
                        *general[name], **kw)))
        log(tag, f"{name} ({src}): q (1, {S_FLASH}, {H}, {d}) {dname}, "
            f"{Hkv} KV heads repeated to {H}, causal, window {window}, "
            f"softcap {softcap}: {held}; "
            f"ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, bound_ms "
            f"{b_ms:.4f} ({b_by}; {pairs * H} unmasked pairs, {nbytes} "
            f"bytes); {lib}; general route ({gkey}, unaligned copies): "
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
    log(tag, f"{dname} local/global time {ratio:.3f} (unmasked pairs "
        f"{pair_ratio:.3f}): the key-tile skip under the window; the "
        f"{dname} phase took {time.perf_counter() - t_phase:.1f} s")
    return [flash_entry(key, launches.get(key, 0), err, rows, "qwen3-0.6b"),
            flash_entry(gkey, glaunches.get(gkey, 0), gerr, grows,
                        "qwen3-0.6b")]


def run_flash(cuda: torch.device) -> list:
    """K5 at full model width: bf16, then float16, on the three shapes
    (``run_flash_16``: the Hopper kernel and the general one, each with
    its own launch counts), one float32 check with its own launch count,
    and the wide routes (``run_flash_wide``).  Returns K5's entries of
    the kernels' record: ``flash``, ``flash_general``, ``flash_f16``,
    ``flash_f16_general``, ``flash_f32``, ``flash_wide``,
    ``flash_realign``, ``flash_wide_cluster`` and
    ``flash_wide_general``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls must run in full float32")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    def rel_l2(got, want):
        return float((got - want).norm() / want.norm())

    entries = [*run_flash_16(normal, torch.bfloat16, "flash",
                             "flash_general"),
               *run_flash_16(normal, torch.float16, "flash_f16",
                             "flash_f16_general")]

    # float32: Qwen3 width at S=2048, 3xTF32 on the tensor cores, against
    # the plain version in full float32, with its own launch count; SDPA
    # on float32 as its yardstick, held to the same relative L2
    S32 = 2048
    q, k, v = (normal((16, S32, 128), torch.float32) for _ in range(3))
    _build.launches.clear()
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches32 = dict(_build.launches)
    log("flash", f"kernel launches on the float32 check: {launches32}")
    check(launches32 == {"flash_f32": 1}, "the float32 check did not take "
          "the float32 kernel (flash_f32) once and nothing else")
    want = flash_ref.attention_ref(q, k, v, causal=True)
    e32, rel32 = within_limits("float32 (flash_f32)", got, want,
                               torch.float32)
    # the bound of 3xTF32: three tensor-core passes of both products;
    # beside it, for the record, the bound on the CUDA cores
    ops32 = 4 * 16 * 128 * causal_pairs(S32, 0)
    b32, b32_by = bound(4 * q.numel() * 4, 3 * ops32, TF32_OPS_PER_S)
    b32_cores, _ = bound(4 * q.numel() * 4, ops32, FP32_OPS_PER_S)

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
             "bound_ms": b32, "bound_by": b32_by,
             "bound_ms_cuda_cores": b32_cores, "library_ms": lib32}
    log("flash", f"float32 (16, {S32}, 128) causal: max |kernel - plain| "
        f"{e32:.3g} (held at rtol = atol = 2e-5), relative L2 {rel32:.3g} "
        f"(limit 1e-5); ms {row32['ms']:.4f}, plain_ms "
        f"{row32['plain_ms']:.4f}, bound_ms {b32:.4f} ({b32_by}: 3 x "
        f"{ops32} operations over {TF32_OPS_PER_S:.3g}/s TF32; on the "
        f"float32 CUDA cores {b32_cores:.4f}); library_ms {lib32} (SDPA on "
        f"float32, relative L2 {lib_rel32:.3g} off the plain version"
        + ("" if lib32 is not None else ": above 1e-5, so not timed as "
           "this function") + ")")
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return [*entries,
            flash_entry("flash_f32", launches32.get("flash_f32", 0), e32,
                        [row32], "qwen3-0.6b float32"),
            *run_flash_wide(cuda, normal)]


# The model phase (``run_models``): serving as ``examples/serve_balanced.py``
# does at the smoke size, here at Qwen3-0.6B's full width
SERVE_ARCH = "qwen3_0_6b"
N_REQUESTS, N_REPLICAS, DECODE_STEPS = 64, 8, 32
MODEL_TOL = 1e-4          # card vs CPU and teacher forcing: x max |reference|
TF_S = 64                 # Qwen3 teacher forcing and card-vs-CPU prompt
GEMMA_S = 4608            # gemma2-9b prompt, past its 4096-token window
#: the configs the model path ports (dense and VLM)
MODEL_ARCHS = ["qwen3_0_6b", "granite_3_2b", "gemma2_9b", "stablelm_1_6b",
               "internvl2_2b"]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flops(fn) -> int:
    """The operations of one call of ``fn``: its matmuls' multiply-adds
    x 2, as ``torch.utils.flop_counter.FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def busy_ms(fn) -> tuple[float, int]:
    """Device time (ms) of one call of ``fn`` by ``torch.profiler``: the sum
    of its kernels' and copies' durations (one stream, so no overlap), and
    their count.  Only the device's activity is traced, and its events are
    read as the profiler recorded them: parsing every host-side op of a
    call of 10,000-20,000 kernels into a tree took seconds a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in ev) / 1e6, len(ev)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """max |got - want| / max |want|, and max |got - want|."""
    d = float((got.cpu().double() - want.cpu().double()).abs().max())
    return d / float(want.abs().max()), d


class RouteTap:
    """Records every MoE routing of the port (``layers.moe_route``, a
    ``Routing``) made inside a with-block, in call order."""

    def __enter__(self):
        from repro_torch.models import layers
        self.routes, self._route = [], layers.moe_route

        def keep(p, cfg, xg):
            self.routes.append(self._route(p, cfg, xg))
            return self.routes[-1]

        layers.moe_route = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe_route = self._route


def route_flips(card, cpu, B: int, what: str) -> tuple[set, int]:
    """Hold the card's MoE routings to the CPU's, call by call: the expert
    ids equal, except tokens whose first differing choice is a near tie
    (the CPU's probabilities of the two experts within ``ROUTE_TIE`` of each
    other, relative: float32 sums in another order), and the capacity slots
    of every group without such a token equal.  A batch row (of B) that
    holds such a token is another sequence from there on.  Returns those
    rows and the number of tokens."""
    check(len(card) == len(cpu), f"{what}: {len(card)} MoE calls on the "
          f"card, {len(cpu)} on the CPU")
    rows, n = set(), 0
    for a, b in zip(card, cpu):
        ids, slots = a.ids.cpu(), a.slots.cpu()
        G, g, _ = ids.shape
        for gi in range(G):
            bad = (ids[gi] != b.ids[gi]).any(-1).nonzero().flatten().tolist()
            if not bad:
                check(torch.equal(slots[gi], b.slots[gi]),
                      f"{what}: capacity slots differ between card and CPU")
            for t in bad:
                row = (gi * g + t) // (G * g // B)
                if row in rows:
                    continue
                j = int((ids[gi, t] != b.ids[gi, t]).nonzero()[0])
                p = torch.sort(b.probs[gi, t], descending=True).values
                check(float(p[j] - p[j + 1]) <= ROUTE_TIE * float(p[j]),
                      f"{what}: token {t} routed to {ids[gi, t].tolist()} on "
                      f"the card, {b.ids[gi, t].tolist()} on the CPU, no "
                      f"near tie ({float(p[j]):.9g}, {float(p[j + 1]):.9g})")
                rows.add(row)
                n += 1
    return rows, n


def card_vs_cpu(cuda, cfg, params, toks, pe, full: bool) -> str:
    """The model on the card and on the CPU at float32 (``forward`` when
    ``full``, ``prefill``, one decode step, the cache): each within
    ``MODEL_TOL`` x max |CPU|, the cache positions equal and, for a MoE
    model, the routing equal (``route_flips``; a row a near tie flipped is
    left out of the comparisons).  Returns the errors."""
    from repro_torch.models import lm
    pc = _tree_to(params, "cpu")
    B, T = toks.shape[0], toks.shape[1] + cfg.vision_len
    res, routes = {}, {}
    for side, dev, p in (("card", cuda, params), ("cpu", "cpu", pc)):
        r = res[side] = {}
        with RouteTap() as tap:
            if full:
                r["forward"] = lm.forward(p, cfg, toks, pe, device=dev)[0]
            cache = lm.init_cache(cfg, B, T + 1, device=dev)
            r["prefill"], cache = lm.prefill(p, cfg, toks, cache, pe,
                                             device=dev)
            tok = res["card"]["prefill"][:, -1].argmax(-1).int()[:, None]
            r["decode"], cache = lm.decode_step(
                p, cfg, tok, torch.full((B,), T), cache, device=dev)
        routes[side] = tap.routes
        r.update(cache["attn"])
    got, want = res["card"], res["cpu"]
    check(torch.equal(got.pop("pos").cpu(), want.pop("pos")),
          f"{cfg.name}: cache positions differ between card and CPU")
    flipped, n = route_flips(routes["card"], routes["cpu"], B, cfg.name)
    keep = [b for b in range(B) if b not in flipped]
    check(keep, f"{cfg.name}: near ties flipped the routing of every row")

    def rows(k, t):         # logits (B, ...), cache entries (L, B, ...)
        return t[:, keep] if k in cache["attn"] else t[keep]

    errs = {k: _rel_err(rows(k, got[k]), rows(k, want[k])) for k in got}
    bad = {k: e for k, e in errs.items() if e[0] > MODEL_TOL}
    check(not bad, f"{cfg.name}: card vs CPU {bad} (limit {MODEL_TOL} "
          f"x max|CPU|)")
    out = ", ".join(f"{k} {e[0]:.3g} ({e[1]:.3g})" for k, e in errs.items())
    if routes["cpu"]:
        out += (f"; routing of {len(routes['cpu'])} MoE calls: ids and slots "
                f"equal but {n} near-tie tokens (rows {sorted(flipped)} left "
                f"out)")
    return out


def teacher_forcing(cuda, cfg, params, toks) -> torch.Tensor:
    """forward's last logits; checks that prefill on S-1 tokens and one
    decode step give them."""
    from repro_torch.models import lm
    S = toks.shape[1]
    full = lm.forward(params, cfg, toks, device=cuda)[0][:, -1]
    cache = lm.init_cache(cfg, 1, S, device=cuda)
    _, cache = lm.prefill(params, cfg, toks[:, :-1], cache, device=cuda)
    dec, _ = lm.decode_step(params, cfg, toks[:, -1:],
                            torch.full((1,), S - 1), cache, device=cuda)
    rel, d = _rel_err(dec[:, 0], full)
    check(rel <= MODEL_TOL, f"{cfg.name}: decode vs the whole sequence "
          f"{rel:.3g} x max (limit {MODEL_TOL})")
    log("models", f"{cfg.name} ({cfg.n_layers} layers) float32 S={S}: "
        f"prefill on {S - 1} tokens and one decode step vs forward's "
        f"last logits, max|d| {d:.3g} = {rel:.3g} x max |logits| "
        f"(limit {MODEL_TOL})")
    return full


def serve_group(cuda, model, params, group, rng, card: str) -> None:
    """One replica's requests, left-padded with token 0 to the longest (the
    pads are attended, as in the reference; an SSM scans them), prefilled
    and decoded greedily for ``DECODE_STEPS`` steps; logs times beside their
    bounds.  An encoder-decoder gets seeded stub frames."""
    from repro_torch.models import layers, lm, ssm
    cfg = model.cfg
    prompts = [rng.integers(0, cfg.vocab_size, r.prompt_tokens)
               for r in group.requests]
    B, S = len(prompts), max(len(q) for q in prompts)
    S = layers.moe_padded_len(cfg, B, S)     # S itself without experts
    toks = np.zeros((B, S), np.int32)
    for i, q in enumerate(prompts):
        toks[i, S - len(q):] = q
    toks = torch.from_numpy(toks).to(cuda)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (B, cfg.encoder_len, cfg.d_model), device=cuda,
            generator=torch.Generator(cuda).manual_seed(SEED))
    ctx = S + DECODE_STEPS
    tag = f"replica {group.replica}'s group"
    groups = (f" (P15: B*S = {B * S} tokens, {max(1, B * S // cfg.moe_group)}"
              f" dispatch group(s) of {min(B * S, cfg.moe_group)})"
              if cfg.n_experts else "")
    if cfg.uses_ssm:
        groups += (f", SSD chunks of {ssm.chunk_size(cfg, S)} (the largest "
                   f"divisor of S not above {cfg.ssm_chunk})")
    if cfg.family == "encdec":
        groups += f", stub frames ({B}, {cfg.encoder_len}, {cfg.d_model})"
    log("models", f"{cfg.name} {cfg.dtype} serving {tag}: B={B}, prompt "
        f"lengths {[len(q) for q in prompts]}, left-padded with token 0 to "
        f"S={S}{groups}, cache {ctx}")

    def prefill(cache):
        return model.prefill(params, batch, cache, device=cuda)

    prefill(model.init_cache(B, ctx, device=cuda))      # warm-up, untimed
    pre_ms = []
    for _ in range(3):
        cache = model.init_cache(B, ctx, device=cuda)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cache)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms, out = [], []
    tok = logits[:, -1].argmax(-1).int()[:, None]
    for t in range(DECODE_STEPS):
        out.append(tok)
        pos = torch.full((B,), S + t, dtype=torch.int32, device=cuda)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, tok, pos, cache, device=cuda)
        tok = logits[:, -1].argmax(-1).int()[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    check(logits.shape == (B, 1, cfg.padded_vocab), f"{tag}: logits of "
          f"shape {tuple(logits.shape)}")
    attn = cache.get("attn", cache.get("self"))
    if attn is not None:
        # slot j of a ring of Sc slots holds the last position p < ctx with
        # p % Sc == j; without a ring (Sc >= ctx) that is j itself
        Sc = attn["pos"].shape[2]
        j = torch.arange(min(Sc, ctx), dtype=torch.int32)
        pos_ok = attn["pos"][:, :, :ctx].cpu()
        check(torch.equal(pos_ok, (j + Sc * ((ctx - 1 - j) // Sc))
                          .expand_as(pos_ok)),
              f"{tag}: the cache does not hold positions 0..{ctx - 1}")
    if "ssm" in cache:
        state = cache["ssm"]["state"]
        check(bool(torch.isfinite(state).all()) and
              float(state.abs().max()) > 0,
              f"{tag}: the SSM state is not finite and non-zero")

    # bounds: the larger of the operations over the bf16 tensor cores' peak
    # and the bytes over the memory rate (every weight read once, an untied
    # embedding's rows only; for decode also the valid cache entries, the
    # mean step's)
    kv_len = S + (DECODE_STEPS + 1) / 2
    if cfg.family in ("ssm", "hybrid", "encdec"):
        pre_bound, pre_desc, dec_bound, dec_desc = recurrent_bounds(
            model, params, cache, B, S, kv_len,
            lambda: prefill(model.init_cache(B, ctx, device=cuda)),
            lambda: model.decode(params, tok, pos, cache, device=cuda))
    else:
        pre_bound, pre_desc, dec_bound, dec_desc = attention_bounds(
            model, params, cache, B, S, kv_len,
            lambda: prefill(model.init_cache(B, ctx, device=cuda)),
            lambda: model.decode(params, tok, pos, cache, device=cuda))
    dec_med = statistics.median(step_ms)
    tps = B * DECODE_STEPS / (sum(step_ms) / 1e3)
    log("models", f"{tag} on {card}: prefill {statistics.median(pre_ms):.2f} "
        f"ms (median of 3: {', '.join(f'{x:.2f}' for x in pre_ms)}), bound "
        f"{pre_bound[0]:.4f} ms by {pre_bound[1]} ({pre_desc}); "
        f"decode {dec_med:.2f} ms a step (median of {DECODE_STEPS}; min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}), bound "
        f"{dec_bound[0]:.4f} ms by {dec_bound[1]} ({dec_desc}); {tps:.1f} "
        f"decoded tokens/s ({B} x {DECODE_STEPS} tokens); first row's "
        f"tokens {torch.cat(out, 1)[0, :8].tolist()}")
    fresh = model.init_cache(B, ctx, device=cuda)
    for what, fn, wall in (("prefill", lambda: prefill(fresh),
                            statistics.median(pre_ms)),
                           ("decode step", lambda: model.decode(
                               params, tok, pos, cache, device=cuda),
                            dec_med)):
        busy, n = busy_ms(fn)
        log("models", f"{tag}, {what} on {card}: the card is busy "
            f"{busy:.2f} ms of {wall:.2f} (torch.profiler; idle share "
            f"{1 - busy / wall:.3f}) in {n} kernels and copies")


def attention_bounds(model, params, cache, B: int, S: int, kv_len: float,
                     prefill, decode):
    """The prefill and decode bounds of a dense, VLM or MoE model (each the
    larger of its operations over the bf16 tensor cores' peak and its bytes
    over the memory rate) and how each was reckoned: every weight read
    once, an untied embedding's rows only; for decode also the valid cache
    entries, the mean step's (``kv_len`` of them)."""
    from repro_torch.models import lm
    cfg = model.cfg
    wbytes = sum(t.numel() * t.element_size() for t in lm.leaves(params))
    if not cfg.tie_embeddings:
        wbytes -= (cfg.padded_vocab - B * S) * cfg.d_model * \
            params["embed"].element_size()
    kv_bytes = B * kv_len * cfg.n_layers * sum(
        t[0, 0, 0].numel() * t.element_size()
        for k, t in cache["attn"].items() if k != "pos")
    if cfg.n_experts:
        # the matmuls as they run (FlopCounterMode): the one-hot dispatch
        # computes every expert's moe_capacity slots, and MLA's and the
        # chunked attention's shapes are not a closed form
        pre_ops = flops(prefill)
        dec_ops = flops(decode)
    else:
        mats = sum(t.numel() for t in lm.leaves(params["layers"])
                   if t.dim() > 2)
        # QK and PV of one query-key pair, over the layers, heads and rows
        attn = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * B
        head = 2 * B * cfg.d_model * cfg.padded_vocab
        pre_ops = 2 * B * S * mats + head + attn * S * (S + 1) // 2
        dec_ops = 2 * B * mats + head + attn * kv_len
    pre_bound = bound(wbytes, pre_ops, BF16_TC_OPS_PER_S)
    dec_bound = bound(wbytes + kv_bytes, dec_ops, BF16_TC_OPS_PER_S)

    def both(ops, nbytes):
        return (f"{ops / BF16_TC_OPS_PER_S * 1e3:.4f} ms for {ops:.0f} "
                f"operations over 989 TFLOP/s bf16, "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms for {nbytes:.0f} "
                f"bytes over 3.35 TB/s")

    return (pre_bound, both(pre_ops, wbytes), dec_bound,
            f"{both(dec_ops, wbytes + kv_bytes)}: the weights and "
            f"{kv_bytes:.0f} cache bytes")


def flops_by_dtype(fn) -> dict:
    """The operations of one call of ``fn`` by the dtype of each counted
    op's first operand: ``FlopCounterMode``'s count of each op (its
    matmuls' multiply-adds x 2), read in a dispatch mode of our own."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    counts: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in flop_registry:
                dt = args[0].dtype
                counts[dt] = counts.get(dt, 0) + flop_registry[packet](
                    *args, **kwargs, out_val=out)
            return out

    with Count():
        fn()
    return counts


def recurrent_bounds(model, params, cache, B: int, S: int, kv_len: float,
                     prefill, decode):
    """The prefill and decode bounds of an SSM, hybrid or encoder-decoder
    model and how each was reckoned.  Operations: what the call's matmuls
    do (``flops_by_dtype``), bf16 ones over the tensor cores' 989 TFLOP/s
    and float32 ones (the SSD scan's contractions, full float32) over 67
    TFLOP/s.  Bytes: the weights a call reads (an untied embedding's and
    the learned decoder positions' rows only; decode reads no encoder
    weight), the stub frames, and the cache: attention entries written by
    prefill, the mean decode step's valid entries read and its own
    written, the SSM state and conv tail read and written by every call,
    the encoder states written by prefill and read by every decode step."""
    from repro_torch.models import lm
    cfg = model.cfg

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in lm.leaves(tree))

    row = cfg.d_model * params["embed"].element_size()
    w_pre = w_dec = nbytes(params)
    if not cfg.tie_embeddings:
        w_pre -= (cfg.padded_vocab - B * S) * row
        w_dec -= (cfg.padded_vocab - B) * row
    extra_pre = extra_dec = 0
    if cfg.family == "encdec":
        rows = params["dec_pos"].shape[0]
        w_pre -= (rows - S) * row
        w_dec -= (nbytes(params["enc_layers"]) + nbytes(params["enc_pos"])
                  + nbytes(params["enc_ln"]) + (rows - B) * row)
        extra_pre = B * cfg.encoder_len * cfg.d_model * 4 + nbytes(
            cache["enc"])                      # the frames, enc written
        extra_dec = nbytes(cache["enc"])
    attn = cache.get("attn", cache.get("self"))
    if attn is not None:
        per_token = cfg.n_layers * sum(
            t[0, 0, 0].numel() * t.element_size()
            for k, t in attn.items() if k != "pos")
        extra_pre += B * S * per_token
        extra_dec += B * (kv_len + 1) * per_token
    if "ssm" in cache:
        extra_pre += 2 * nbytes(cache["ssm"])
        extra_dec += 2 * nbytes(cache["ssm"])
    out = []
    for fn, nb in ((prefill, w_pre + extra_pre), (decode, w_dec + extra_dec)):
        ops = flops_by_dtype(fn)
        o16 = ops.pop(torch.bfloat16, 0)
        o32 = sum(ops.values())
        t_ops = (o16 / BF16_TC_OPS_PER_S + o32 / FP32_OPS_PER_S) * 1e3
        t_bytes = nb / HBM_BYTES_PER_S * 1e3
        out.append(((t_bytes, "bytes") if t_bytes >= t_ops
                    else (t_ops, "operations")))
        out.append(f"{t_ops:.4f} ms for {o16:.0f} bf16 operations over 989 "
                   f"TFLOP/s and {o32:.0f} float32 over 67 TFLOP/s, "
                   f"{t_bytes:.4f} ms for {nb:.0f} bytes over 3.35 TB/s")
    return tuple(out)


def run_models(cuda: torch.device) -> None:
    """The decoder-only model path (``models.api``), with its own launch
    counts: Qwen3-0.6B at full width in bf16 serving two replica groups of
    the batcher's plan; card vs CPU at float32 (Qwen3-0.6B at full width,
    every dense and VLM smoke config); teacher forcing at full width
    (Qwen3-0.6B, and gemma2-9b's two first layers past its window)."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import api, lm
    from repro_torch.serve import batcher

    t_phase = time.perf_counter()
    card = card_line()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32")
    _build.launches.clear()

    # -- serving ----------------------------------------------------------
    rng = np.random.default_rng(SEED)
    lens = np.minimum((rng.pareto(1.5, N_REQUESTS) * 24 + 8).astype(int), 192)
    reqs = [batcher.Request(i, int(n)) for i, n in enumerate(lens)]
    plan = batcher.plan(reqs, N_REPLICAS, algo="optimal")
    log("models", f"{N_REQUESTS} requests over {N_REPLICAS} replicas "
        f"(optimal): loads {[a.load for a in plan]}, groups of "
        f"{[len(a.requests) for a in plan]} requests")
    cfg = configs.get(SERVE_ARCH)
    model = api.build(cfg)
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(cuda).manual_seed(SEED), device=cuda)
    init_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    largest = max(plan, key=lambda a: len(a.requests))
    for group in (plan[0], largest):
        serve_group(cuda, model, params, group, rng, card)
    log("models", f"peak memory (torch.cuda.max_memory_allocated, above the "
        f"{base} bytes earlier phases hold) on {card}: serving both groups "
        f"{torch.cuda.max_memory_allocated() - base} bytes, the bf16 weights "
        f"({2 * api.count_params(cfg)} bytes) included; the seeded init "
        f"{init_peak} bytes (the weights and one float32 draw)")
    del params

    # -- card vs CPU, float32 ---------------------------------------------
    cfg32 = cfg.scaled(dtype="float32")
    p32 = lm.init_params(torch.Generator(cuda).manual_seed(SEED), cfg32,
                         device=cuda)
    toks = rng.integers(0, cfg.vocab_size, (1, TF_S)).astype(np.int32)
    log("models", f"{cfg.name} B=1 S={TF_S} prefill + one decode step: "
        f"card vs CPU float32, max|d| / max|CPU| (max|d|) "
        f"{card_vs_cpu(cuda, cfg32, p32, toks, None, False)} (limit {MODEL_TOL} x "
        f"max|CPU|); cache pos equal")
    for arch in MODEL_ARCHS:
        sc = configs.get_smoke(arch).scaled(dtype="float32")
        ps = lm.init_params(torch.Generator(cuda).manual_seed(SEED), sc,
                            device=cuda)
        st = rng.integers(0, sc.vocab_size, (2, 21)).astype(np.int32)
        pe = (rng.standard_normal((2, sc.vision_len, sc.d_model)).astype(
            np.float32) if sc.family == "vlm" else None)
        log("models", f"{sc.name} forward, prefill, decode: card vs CPU "
            f"float32, max|d| / max|CPU| (max|d|) "
            f"{card_vs_cpu(cuda, sc, ps, st, pe, True)} (limit {MODEL_TOL} x "
            f"max|CPU|); cache pos equal")

    # -- teacher forcing at full width, float32 -----------------------------
    teacher_forcing(cuda, cfg32, p32, toks)
    del p32
    g = configs.get("gemma2_9b").scaled(n_layers=2, dtype="float32")
    pg = lm.init_params(torch.Generator(cuda).manual_seed(SEED), g,
                        device=cuda)
    gt = rng.integers(0, g.vocab_size, (1, GEMMA_S)).astype(np.int32)
    windowed = teacher_forcing(cuda, g, pg, gt)
    ng = g.scaled(sliding_window=0)
    unwindowed = lm.prefill(pg, ng, gt, lm.init_cache(ng, 1, GEMMA_S,
                                                      device=cuda),
                            device=cuda)[0][:, 0]
    moved = float((windowed - unwindowed).abs().max())
    check(moved > 10 * MODEL_TOL * float(windowed.abs().max()),
          f"gemma2-9b: removing the window moves the last logits by only "
          f"{moved:.3g}")
    log("models", f"gemma2-9b (2 layers, softcaps, post-norms, scale_embed, "
        f"geglu) S={GEMMA_S}: without the window of {g.sliding_window} the "
        f"last logits move by {moved:.3g} (max |logits| "
        f"{float(windowed.abs().max()):.3g}), so layer 0's window masks")
    del pg

    launched = {k: v for k, v in _build.launches.items() if v}
    check(not launched, f"the model path launched kernels: {launched}")
    log("models", f"kernel launches on the model path: 0 of K1-K5 "
        f"({dict(_build.launches)}): the reference's models call the plain "
        f"chunked_attention (src/repro/models/layers.py:73), never the "
        f"Pallas K5, and so does the port; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# The MoE and MLA phase (``run_moe``): the same requests and plan as
# ``run_models``, served at full width with the depth cut to fit the card
MOE_DEPTH = {"mixtral_8x7b": 4, "deepseek_v2_236b": 2}   # of 32 and 60
MOE_REPLICAS = (0, 5)      # B=1 (192 tokens) and B=8 (up to 55 tokens)
ROUTE_TIE = 1e-6           # a card/CPU routing flip is a near tie below this
MOE_S = 256                # mixtral's moe_forward alone: one dispatch group
MLA_S = 64                 # deepseek's mla_forward alone and teacher forcing


def run_moe(cuda: torch.device) -> None:
    """The MoE and MLA model path (``models.api``), with its own launch
    counts: Mixtral-8x7B (4 of 32 layers) and DeepSeek-V2-236B (2 of 60) at
    full width in bf16, each serving replicas 0 and 5 of the batcher's plan
    (padded to a length the MoE takes, P15); card vs CPU at float32 (both
    smoke configs; mixtral's ``moe_forward`` and deepseek's ``mla_forward``,
    prefill and absorbed decode, at full width), routing first; teacher
    forcing at full width on one layer each (deepseek: the absorbed decode
    against the expanded prefill)."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import api, layers, lm
    from repro_torch.serve import batcher

    t_phase = time.perf_counter()
    card = card_line()
    _build.launches.clear()

    # -- serving ----------------------------------------------------------
    rng = np.random.default_rng(SEED)
    lens = np.minimum((rng.pareto(1.5, N_REQUESTS) * 24 + 8).astype(int), 192)
    plan = batcher.plan([batcher.Request(i, int(n)) for i, n in
                         enumerate(lens)], N_REPLICAS, algo="optimal")
    largest = max(plan, key=lambda a: len(a.requests))
    Bl = len(largest.requests)
    Sl = max(r.prompt_tokens for r in largest.requests)
    pads = {a: 1 - largest.load / (Bl * layers.moe_padded_len(
        configs.get(a), Bl, Sl)) for a in MOE_DEPTH}
    log("moe", f"{N_REQUESTS} requests over {N_REPLICAS} replicas (optimal, "
        f"as run_models): groups of {[len(a.requests) for a in plan]} "
        f"requests; serving replicas {MOE_REPLICAS}; replica "
        f"{largest.replica} (B={Bl}, S={Sl}: {Bl * Sl} tokens) is not "
        f"served: no moe_group exceeds or divides that, and padding to "
        f"a length the MoE takes would make "
        f"{', '.join(f'{p:.1%}' for p in pads.values())} of it pads")
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    for arch, depth in MOE_DEPTH.items():
        full = configs.get(arch)
        cfg = full.scaled(n_layers=depth)
        model = api.build(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(cuda).manual_seed(SEED),
                            device=cuda)
        init_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        n = api.count_params(cfg)
        log("moe", f"{full.name}: {depth} of {full.n_layers} layers at full "
            f"width (cut for the card's 80 GB: the whole model has "
            f"{api.count_params(full)} parameters), {n} parameters, "
            f"{2 * n} bf16 bytes")
        for r in MOE_REPLICAS:
            serve_group(cuda, model, params, plan[r], rng, card)
        log("moe", f"{full.name} peak memory (torch.cuda.max_memory_"
            f"allocated, above the {base} bytes earlier phases hold) on "
            f"{card}: serving both groups "
            f"{torch.cuda.max_memory_allocated() - base} bytes, the bf16 "
            f"weights ({2 * n} bytes) included; the seeded init {init_peak} "
            f"bytes (the weights and one float32 draw)")
        del params

    # -- card vs CPU, float32 ---------------------------------------------
    for arch in MOE_DEPTH:
        sc = configs.get_smoke(arch).scaled(dtype="float32")
        ps = lm.init_params(torch.Generator(cuda).manual_seed(SEED), sc,
                            device=cuda)
        st = rng.integers(0, sc.vocab_size, (2, 21)).astype(np.int32)
        log("moe", f"{sc.name} forward, prefill, decode: card vs CPU "
            f"float32, max|d| / max|CPU| (max|d|) "
            f"{card_vs_cpu(cuda, sc, ps, st, None, True)} (limit "
            f"{MODEL_TOL} x max|CPU|); cache pos equal")

    gen = torch.Generator(cuda).manual_seed(SEED)
    mx = configs.get("mixtral_8x7b").scaled(dtype="float32")
    pm = layers.init_moe(gen, mx, torch.float32, cuda)
    x = torch.randn((1, MOE_S, mx.d_model), generator=gen, device=cuda)
    side = []                                    # card, then CPU
    for dev, p in ((cuda, pm), ("cpu", _tree_to(pm, "cpu"))):
        with RouteTap() as tap:
            side.append((layers.moe_forward(p, mx, x.to(dev)), tap.routes))
    del pm
    ((yc, ac), rc), ((yp, ap), rp) = side
    flipped, n_tie = route_flips(rc, rp, MOE_S, "mixtral moe_forward")
    # a token's output follows from its own experts and whether each kept
    # its slot: compare the tokens where both agree
    keep = ((rc[0].slots.cpu() < rc[0].capacity)
            == (rp[0].slots < rp[0].capacity)).all(-1).flatten()
    keep[sorted(flipped)] = False
    rel, d = _rel_err(yc[0].cpu()[keep], yp[0, keep])
    arel = abs(float(ac) - float(ap)) / float(ap)
    check(rel <= MODEL_TOL and arel <= MODEL_TOL,
          f"mixtral moe_forward: card vs CPU {rel:.3g}, aux {arel:.3g}")
    log("moe", f"mixtral-8x7b moe_forward alone at full width (8 experts of "
        f"d_ff 14336, {mx.d_model * mx.n_experts * (3 * mx.d_ff + 1)} float32 "
        f"weights), x (1, {MOE_S}, {mx.d_model}): routing ids and slots card "
        f"= CPU but {n_tie} near-tie tokens (relative gap < {ROUTE_TIE}), "
        f"{rp[0].dropped} of {rp[0].ids.numel()} choices dropped (capacity "
        f"{rp[0].capacity}); out max|d| {d:.3g} = {rel:.3g} x max|CPU| over "
        f"{int(keep.sum())} tokens, aux {arel:.3g} relative (limit "
        f"{MODEL_TOL})")

    ds = configs.get("deepseek_v2_236b").scaled(dtype="float32")
    pa = layers.init_mla(gen, ds, torch.float32, cuda)
    x = torch.randn((1, MLA_S + 1, ds.d_model), generator=gen, device=cuda)
    pos = torch.arange(MLA_S + 1, dtype=torch.int32)[None]
    res = []                                     # card, then CPU
    for dev, p in ((cuda, pa), ("cpu", _tree_to(pa, "cpu"))):
        cache = {"c": torch.zeros((1, MLA_S + 1, ds.kv_lora_rank),
                                  device=dev),
                 "kr": torch.zeros((1, MLA_S + 1, ds.qk_rope_dim),
                                   device=dev),
                 "pos": torch.full((1, MLA_S + 1), -1, dtype=torch.int32,
                                   device=dev)}
        xd, pd = x.to(dev), pos.to(dev)
        pre, _ = layers.mla_forward(p, ds, xd[:, :MLA_S], pd[:, :MLA_S],
                                    window=0, cache=cache)
        dec, _ = layers.mla_forward(p, ds, xd[:, MLA_S:], pd[:, MLA_S:],
                                    window=0, cache=cache, absorb=True)
        res.append({"prefill": pre, "absorbed decode": dec, **cache})
    del pa
    got, want = res
    check(torch.equal(got.pop("pos").cpu(), want.pop("pos")),
          "deepseek mla_forward: cache positions differ")
    errs = {k: _rel_err(got[k], want[k]) for k in got}
    bad = {k: e for k, e in errs.items() if e[0] > MODEL_TOL}
    check(not bad, f"deepseek mla_forward: card vs CPU {bad}")
    log("moe", f"deepseek-v2-236b mla_forward alone at full width (128 "
        f"heads, q_lora 1536, kv_lora 512), prefill of {MLA_S} tokens then "
        f"the absorbed decode: card vs CPU float32, max|d| / max|CPU| "
        f"(max|d|) " + ", ".join(f"{k} {e[0]:.3g} ({e[1]:.3g})"
                                 for k, e in errs.items())
        + f" (limit {MODEL_TOL}); cache pos equal")

    # -- teacher forcing at full width, float32, one layer each ------------
    for arch in MOE_DEPTH:
        c1 = configs.get(arch).scaled(n_layers=1, dtype="float32")
        p1 = lm.init_params(gen, c1, device=cuda)
        with RouteTap() as tap:
            teacher_forcing(cuda, c1, p1, rng.integers(
                0, c1.vocab_size, (1, MLA_S)).astype(np.int32))
        # the same routing only if the whole sequence dropped no choice
        check(not any(r.dropped for r in tap.routes),
              f"{c1.name}: forward dropped choices at capacity")
        del p1

    launched = {k: v for k, v in _build.launches.items() if v}
    check(not launched, f"the MoE path launched kernels: {launched}")
    log("moe", f"kernel launches on the MoE and MLA path: 0 of K1-K5 "
        f"({dict(_build.launches)}): the reference's mla_forward calls the "
        f"plain chunked_attention and its moe_forward plain einsums "
        f"(src/repro/models/layers.py:370-387, :474-478), no Pallas kernel, "
        f"and so does the port; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


# The SSM, hybrid and encoder-decoder phase (``run_ssm_encdec``): the same
# requests and plan as ``run_models``, each model whole in bf16
SSM_ARCHS = ("mamba2_1_3b", "hymba_1_5b", "whisper_large_v3")
CUT = 2            # layers (whisper: of each stack) of the float32 full-width runs
CUT_S = 64         # card vs CPU at full width: a prompt of 64 tokens
SSM_TF_S = 192     # teacher forcing: a prompt of 192 tokens (two SSD chunks of
SSM_TF_STEPS = 4   # 96), then this many decode steps against the whole sequence


def _flat(tree, path: str = "") -> dict:
    """A cache tree's tensors by path (``attn.k``, ``ssm.state``, ``enc``)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}{key}.").items()}
    return {path[:-1]: tree}


def score_and_serve(model, params, toks, extra, dev, steps: int,
                    fed=None) -> tuple[dict, dict, list]:
    """The whole-sequence logits (``forward``; ``decode_train`` for the
    encoder-decoder, whose ``extra`` are the frames), then ``prefill`` and
    ``steps`` greedy decode steps, each feeding the token ``fed[t]`` when
    given.  Returns the logits by call, the cache's tensors by path and the
    tokens fed."""
    from repro_torch.models import encdec, lm
    cfg = model.cfg
    B, S = toks.shape
    if cfg.family == "encdec":
        full = encdec.decode_train(params, cfg, extra, toks, device=dev)
        batch = {"tokens": toks, "frames": extra}
    else:
        full = lm.forward(params, cfg, toks, device=dev)[0]
        batch = {"tokens": toks}
    logits, cache = model.prefill(params, batch,
                                  model.init_cache(B, S + steps, device=dev),
                                  device=dev)
    out, fed = {"forward": full, "prefill": logits}, list(fed or [])
    for t in range(steps):
        if len(fed) == t:
            fed.append(logits[:, -1].argmax(-1).int()[:, None].cpu())
        logits, cache = model.decode(params, fed[t], torch.full((B,), S + t),
                                     cache, device=dev)
        out[f"decode {t}"] = logits
    return out, _flat(cache), fed


def card_vs_cpu_all(cuda, model, params, toks, extra) -> str:
    """The model on the card and on the CPU at float32 (``score_and_serve``
    with two decode steps, the CPU fed the card's tokens): every output and
    every cache tensor (attention entries, the SSM's state and conv tail,
    the encoder states) within ``MODEL_TOL`` x max |CPU|, the cache
    positions equal.  Returns the errors."""
    got, gcache, fed = score_and_serve(model, params, toks, extra, cuda, 2)
    want, wcache, _ = score_and_serve(model, _tree_to(params, "cpu"), toks,
                                      extra, "cpu", 2, fed)
    for k in [k for k in gcache if k.endswith("pos")]:
        check(torch.equal(gcache.pop(k).cpu(), wcache.pop(k)),
              f"{model.cfg.name}: cache {k} differs between card and CPU")
    errs = {k: _rel_err(got[k], want[k]) for k in got}
    errs.update({f"cache {k}": _rel_err(gcache[k], wcache[k])
                 for k in gcache})
    bad = {k: e for k, e in errs.items() if e[0] > MODEL_TOL}
    check(not bad, f"{model.cfg.name}: card vs CPU {bad} (limit {MODEL_TOL} "
          f"x max|CPU|)")
    return ", ".join(f"{k} {e[0]:.3g} ({e[1]:.3g})" for k, e in errs.items())


def teacher_forcing_steps(cuda, model, params, toks, extra) -> None:
    """Prefill on all but the last ``SSM_TF_STEPS`` tokens, then decode
    those one by one: each call's logits against the whole sequence's at
    the same position, within ``MODEL_TOL`` x max."""
    from repro_torch.models import ssm
    cfg = model.cfg
    S = toks.shape[1] - SSM_TF_STEPS
    out, _, _ = score_and_serve(model, params, toks[:, :S], extra, cuda,
                                SSM_TF_STEPS,
                                fed=[toks[:, S + t:S + t + 1]
                                     for t in range(SSM_TF_STEPS)])
    full, _, _ = score_and_serve(model, params, toks, extra, cuda, 0)
    full = full["forward"]
    errs = [_rel_err(out["prefill"][:, 0], full[:, S - 1])] + [
        _rel_err(out[f"decode {t}"][:, 0], full[:, S + t])
        for t in range(SSM_TF_STEPS)]
    worst = max(e[0] for e in errs)
    check(worst <= MODEL_TOL, f"{cfg.name}: decode vs the whole sequence "
          f"{worst:.3g} x max (limit {MODEL_TOL})")
    what = {"ssm": "the recurrent step against the chunked scan (chunks of "
                   f"{ssm.chunk_size(cfg, S)} in prefill, "
                   f"{ssm.chunk_size(cfg, S + SSM_TF_STEPS)} whole)",
            "hybrid": "the attention cache and the recurrent step "
                      "against the chunked scan",
            "encdec": "the self-attention cache and the cross-attention "
                      "recomputed from cache['enc']"}[cfg.family]
    log("ssm", f"{cfg.name} ({CUT} layers, float32) teacher forcing: "
        f"prefill on {S} tokens and {SSM_TF_STEPS} decode steps vs the "
        f"whole sequence's logits at the same positions ({what}): max|d| / "
        f"max per call {', '.join(f'{e[0]:.3g}' for e in errs)} (limit "
        f"{MODEL_TOL})")


def run_ssm_encdec(cuda: torch.device) -> None:
    """The SSM, hybrid and encoder-decoder model path (``models.api``), with
    its own launch counts: Mamba2-1.3B, Hymba-1.5B and Whisper-large-v3 at
    full width and full depth in bf16, each serving replica 0's group and
    the plan's largest (as ``run_models``); card vs CPU at float32 (the
    three smoke configs, and each model cut to 2 layers at full width:
    the whole-sequence logits, prefill with its cache, two decode steps);
    teacher forcing on the same cut (the SSM's recurrent step against its
    chunked scan, whisper's self-cache and recomputed cross-attention)."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.serve import batcher

    t_phase = time.perf_counter()
    card = card_line()
    _build.launches.clear()

    # -- serving ----------------------------------------------------------
    rng = np.random.default_rng(SEED)
    lens = np.minimum((rng.pareto(1.5, N_REQUESTS) * 24 + 8).astype(int), 192)
    plan = batcher.plan([batcher.Request(i, int(n)) for i, n in
                         enumerate(lens)], N_REPLICAS, algo="optimal")
    largest = max(plan, key=lambda a: len(a.requests))
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    for arch in SSM_ARCHS:
        cfg = configs.get(arch)
        model = api.build(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(cuda).manual_seed(SEED),
                            device=cuda)
        init_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        n = api.count_params(cfg)
        log("ssm", f"{cfg.name}: all {cfg.n_layers} layers"
            f"{f' and {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}"
            f" at full width, {n} parameters, {2 * n} bf16 bytes")
        for group in (plan[0], largest):
            serve_group(cuda, model, params, group, rng, card)
        log("ssm", f"{cfg.name} peak memory (torch.cuda.max_memory_"
            f"allocated, above the {base} bytes earlier phases hold) on "
            f"{card}: serving both groups "
            f"{torch.cuda.max_memory_allocated() - base} bytes, the bf16 "
            f"weights ({2 * n} bytes) included; the seeded init {init_peak} "
            f"bytes (the weights and one float32 draw)")
        del params

    # -- card vs CPU and teacher forcing, float32 --------------------------
    for arch in SSM_ARCHS:
        smoke = configs.get_smoke(arch).scaled(dtype="float32")
        cut = configs.get(arch).scaled(
            n_layers=CUT, dtype="float32",
            encoder_layers=CUT if smoke.encoder_layers else 0)
        for cfg, B, S in ((smoke, 2, 21), (cut, 1, CUT_S)):
            model = api.build(cfg)
            params = model.init(torch.Generator(cuda).manual_seed(SEED),
                                device=cuda)
            toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            extra = (rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
                     .astype(np.float32) if cfg.family == "encdec" else None)
            log("ssm", f"{cfg.name} ({cfg.n_layers} layers) B={B} S={S}: "
                f"card vs CPU float32, max|d| / max|CPU| (max|d|) "
                f"{card_vs_cpu_all(cuda, model, params, toks, extra)} (limit "
                f"{MODEL_TOL} x max|CPU|); cache pos equal")
        toks = rng.integers(0, cut.vocab_size, (1, SSM_TF_S + SSM_TF_STEPS)
                            ).astype(np.int32)
        teacher_forcing_steps(cuda, model, params, toks,
                              None if extra is None else extra[:1])
        del params

    launched = {k: v for k, v in _build.launches.items() if v}
    check(not launched, f"the SSM and encdec path launched kernels: "
          f"{launched}")
    log("ssm", f"kernel launches on the SSM, hybrid and encoder-decoder "
        f"path: 0 of K1-K5 ({dict(_build.launches)}): the reference's "
        f"ssm.py and encdec.py use plain einsums and the plain "
        f"chunked_attention, no Pallas kernel, and so does the port; phase "
        f"took {time.perf_counter() - t_phase:.1f} s")


TRAIN_ARCH = "qwen3-0.6b"
TRAIN_B, TRAIN_S = 8, 512          # one chunk of chunked_ce: 8 x 512 x V
TRAIN_STEPS, TRAIN_EVERY = 6, 3    # launch.train's run; checkpoints at 3, 6
RESUME_TOL = 2e-2      # |resumed loss - uninterrupted loss| at steps 3-5
#                        (about 12.1 at B=8, S=512; bf16 weights)
TRAIN_CPU_S = 128      # card vs CPU at float32: one step at B=1, S=128
TRAIN_LOSS_TOL = 1e-5  # card vs CPU: loss and grad_norm, relative
TRAIN_GRAD_TOL = 1e-4  # card vs CPU: each leaf's first moment, x max |CPU|
TRAIN_UPD_TOL = 1e-2   # card vs CPU: the update where the gradients agree
#                        within 1%, x lr (a gradient near 0 may change sign)
SMOKE_STEPS = 30       # the reference's integration test: loss falls > 0.5


class StepTap:
    """Wraps ``launch.train``'s train step inside a with-block: records
    each step's host time (the card synchronised before and after), its
    metrics as floats, and keeps the last step's parameters and state;
    records the host seconds of each checkpoint ``save`` and ``restore``
    (``io``)."""

    def __enter__(self):
        from repro_torch.launch import train
        from repro_torch.train import checkpoint
        self.steps, self.last, self._make = [], None, train.make_train_step
        self.io, self._io = [], {k: getattr(checkpoint, k)
                                 for k in ("save", "restore")}
        for name, fn in self._io.items():
            def timed_io(*args, fn=fn, name=name, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.io.append((name, time.perf_counter() - t0))
                return out
            setattr(checkpoint, name, timed_io)

        def make(cfg, opt_cfg):
            step = self._make(cfg, opt_cfg)

            def timed(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, metrics = step(*args, **kw)
                torch.cuda.synchronize()
                self.steps.append(((time.perf_counter() - t0) * 1e3,
                                   {k: float(v) for k, v in metrics.items()}))
                self.last = (params, state)
                return params, state, metrics
            return timed

        train.make_train_step = make
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train
        from repro_torch.train import checkpoint
        train.make_train_step = self._make
        for name, fn in self._io.items():
            setattr(checkpoint, name, fn)

    def io_line(self) -> str:
        return ", ".join(f"{name} {sec:.1f} s" for name, sec in self.io)


def top_kernels(fn, k: int = 6) -> str:
    """The ``k`` kernels with the most device time in one call of ``fn``
    (torch.profiler's device events, grouped by name): ms and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    tot: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().replace("void ", "").split("<")[0].split("(")[0]
            t, c = tot.get(name, (0, 0))
            tot[name] = (t + e.duration_ns(), c + 1)
    top = sorted(tot.items(), key=lambda kv: -kv[1][0])[:k]
    return "; ".join(f"{n[-60:]} {t / 1e6:.1f} ms ({c}x)"
                     for n, (t, c) in top)


def train_stages(cuda, model, opt_cfg, params, opt_state, batch) -> str:
    """Host-clock ms of a train step's three stages, as ``make_train_step``
    runs them, the card synchronised between: the loss (forward, building
    the graph), ``autograd.grad`` (the layers' and the chunk's recompute,
    then the backward) and ``optim.apply``; the second of two runs."""
    from repro_torch.models import lm
    from repro_torch.train import optim
    for _ in range(2):
        t = [time.perf_counter()]
        wrt = optim.tree_map(lambda x: x.detach().requires_grad_(), params)
        loss, _ = model.loss(wrt, batch, device=cuda)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        grads = iter(torch.autograd.grad(loss, lm.leaves(wrt)))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        optim.apply(opt_cfg, params, opt_state,
                    optim.tree_map(lambda _: next(grads), wrt))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        del wrt, loss
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return (f"loss (forward) {ms[0]:.1f} ms, autograd.grad (recompute and "
            f"backward) {ms[1]:.1f} ms, optim.apply {ms[2]:.1f} ms")


def _leaves_by_path(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves_by_path(sub, f"{path}/{key}").items()}
    return {path: tree}


def train_card_vs_cpu(cuda, cfg, B: int, S: int) -> str:
    """One train step (``launch.train``'s AdamW defaults) from the same float32
    parameters on the card and on the CPU: the loss and ``grad_norm``
    within ``TRAIN_LOSS_TOL``; every leaf's first moment (0.1 x the clipped
    gradient) within ``TRAIN_GRAD_TOL`` x max |CPU|; and the parameters'
    update within ``TRAIN_UPD_TOL`` x lr wherever the two gradients agree
    within 1% (at step 1 AdamW moves each entry by about lr x sign(g), so
    an entry whose gradient is at the float32 noise floor may move the
    other way; those are counted).  Returns the errors."""
    from repro_torch.data import pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.train import optim
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=20)
    step = make_train_step(cfg, opt_cfg)
    params = api.build(cfg).init(torch.Generator(cuda).manual_seed(SEED),
                                 device=cuda)
    batch = pipeline.TokenPipeline(cfg, pipeline.DataConfig(
        global_batch=B, seq_len=S)).batch_at(0)
    out = {}
    for side, dev in (("card", cuda), ("cpu", "cpu")):
        p = _tree_to(params, dev)
        out[side] = (p,) + step(p, optim.init(opt_cfg, p, device=dev), batch,
                                device=dev)
    (p0, pc, sc, mc), (_, pp, sp, mp) = out["card"], out["cpu"]
    rel = {k: abs(mc[k].item() - mp[k].item()) / abs(mp[k].item())
           for k in ("loss", "grad_norm")}
    check(max(rel.values()) <= TRAIN_LOSS_TOL, f"{cfg.name}: train step "
          f"card vs CPU {rel} (limit {TRAIN_LOSS_TOL})")
    lr = mp["lr"].item()
    m_err, upd_err, noise, n = 0.0, 0.0, 0, 0
    p_err, p_lim = 0.0, math.inf    # the largest relative error and the
    #                                 tightest leaf's limit
    cpu_p, cpu_m = _leaves_by_path(pp), _leaves_by_path(sp["m"])
    card_m, start = _leaves_by_path(sc["m"]), _leaves_by_path(p0)
    for k, new in _leaves_by_path(pc).items():
        mk, mw = card_m[k].cpu(), cpu_m[k]
        m_err = max(m_err, float((mk - mw).abs().max() / mw.abs().max()))
        agree = (mk - mw).abs() <= 0.01 * mw.abs()
        p_before = start[k].cpu()
        d = ((new.cpu() - p_before) - (cpu_p[k] - p_before)).abs()
        upd_err = max(upd_err, float(d[agree].max()) / lr
                      if agree.any() else 0.0)
        noise += int((~agree).sum())
        n += mw.numel()
        # an entry may move the other way by at most 2 lr (1 + wd |p|)
        scale = float(cpu_p[k].abs().max())
        r = float((new.cpu() - cpu_p[k]).abs().max()) / scale
        lim = 2 * lr * (1 + opt_cfg.weight_decay * float(
            p_before.abs().max())) / scale
        check(r <= lim, f"{cfg.name}{k}: updated parameters card vs CPU "
              f"{r:.3g} x max (limit {lim:.3g})")
        p_err, p_lim = max(p_err, r), min(p_lim, lim)
    check(m_err <= TRAIN_GRAD_TOL, f"{cfg.name}: first moment card vs CPU "
          f"{m_err:.3g} x max (limit {TRAIN_GRAD_TOL})")
    check(upd_err <= TRAIN_UPD_TOL, f"{cfg.name}: update card vs CPU "
          f"{upd_err:.3g} x lr (limit {TRAIN_UPD_TOL})")
    return (f"loss {mp['loss'].item():.6f}, |d| {rel['loss']:.3g} relative; "
            f"grad_norm {mp['grad_norm'].item():.6f}, {rel['grad_norm']:.3g} "
            f"(limit {TRAIN_LOSS_TOL}); first moment of every leaf within "
            f"{m_err:.3g} x max |CPU| (limit {TRAIN_GRAD_TOL}); update within "
            f"{upd_err:.3g} x lr ({lr:.3g}; limit {TRAIN_UPD_TOL}) at the "
            f"{n - noise} of {n} entries whose gradients agree within 1%, "
            f"{noise} at the noise floor; updated parameters within "
            f"{p_err:.3g} x max |CPU| (each leaf's limit 2 lr (1 + wd "
            f"max|p|) / max|p|, an entry at the noise floor moving the "
            f"other way; the tightest {p_lim:.3g})")


def run_train(cuda: torch.device) -> None:
    """The training path (``launch.train.main``, ``launch.steps``,
    ``train.{optim,checkpoint}``, ``data.pipeline``), with its own launch
    counts: Qwen3-0.6B at full width and full depth in bf16 (float32
    moments) takes ``TRAIN_STEPS`` steps at B=8, S=512 with a checkpoint
    every 3; the checkpoint restores bit for bit; with step 6 uncommitted,
    a second call resumes from step 3 and its losses stay within
    ``RESUME_TOL`` of the first call's; times, kernels a step, idle share,
    peak memory and the FLOP bound; one float32 step at full width on the
    card against the CPU; the smoke config's loss falls by more than 0.5
    in 30 steps on the card; no launch of K1-K5."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api, lm
    from repro_torch.train import checkpoint, optim

    t_phase = time.perf_counter()
    card = card_line()
    _build.launches.clear()
    cfg = configs.get(TRAIN_ARCH)
    n = api.count_params(cfg)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(TRAIN_EVERY), "--log-every", "1"]
    log("train", f"{cfg.name}: all {cfg.n_layers} layers at full width, {n} "
        f"parameters in bf16 ({2 * n} bytes), float32 moments "
        f"({8 * n} bytes); launch.train.main({argv})")
    try:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with StepTap() as tap:
            first = train.main(argv)
        wall1 = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        check(len(tap.steps) == TRAIN_STEPS, f"ran {len(tap.steps)} steps")
        losses = [m["loss"] for _, m in tap.steps]
        check(all(math.isfinite(x) for x in losses) and losses[-1] ==
              first["last_loss"], f"losses {losses}")
        check(checkpoint.latest_step(ckpt) == TRAIN_STEPS,
              "no committed checkpoint at the last step")
        state = {"params": tap.last[0], "opt": tap.last[1]}
        back = checkpoint.restore(ckpt, TRAIN_STEPS, state)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            lm.leaves(state), lm.leaves(back)))
        check(same, "restore(save(state)) differs from the state on the card")
        log("train", f"call 1: {TRAIN_STEPS} steps in {wall1:.1f} s (host "
            f"clock, init and {TRAIN_STEPS // TRAIN_EVERY} checkpoints "
            f"included: {tap.io_line()}), losses "
            f"{[round(x, 4) for x in losses]}; step "
            f"{TRAIN_STEPS}'s checkpoint restored on the card equals the "
            f"state it saved bit for bit ({len(lm.leaves(state))} leaves: "
            f"bf16 params, float32 moments, int32 step)")
        del back

        (ckpt / f"step_{TRAIN_STEPS:08d}" / "COMMITTED").unlink()
        out = io.StringIO()
        with StepTap() as tap2, contextlib.redirect_stdout(out):
            second = train.main(argv)
        check(f"resumed from step {TRAIN_EVERY}" in out.getvalue(),
              f"the second call did not resume from step {TRAIN_EVERY}: "
              f"{out.getvalue()[:200]}")
        for line in out.getvalue().splitlines():
            log("train", f"call 2: {line}")
        resumed = [m["loss"] for _, m in tap2.steps]
        diffs = [abs(a - b) for a, b in zip(resumed, losses[TRAIN_EVERY:])]
        check(len(resumed) == TRAIN_STEPS - TRAIN_EVERY
              and max(diffs) <= RESUME_TOL,
              f"resumed losses {resumed} vs {losses[TRAIN_EVERY:]}")
        log("train", f"call 2 (step {TRAIN_STEPS} uncommitted): printed "
            f"'resumed from step {TRAIN_EVERY}'; steps {TRAIN_EVERY}-"
            f"{TRAIN_STEPS - 1} ({tap2.io_line()}) losses {resumed} against "
            f"the uninterrupted "
            f"{losses[TRAIN_EVERY:]}, |d| {diffs} (limit {RESUME_TOL}: the "
            f"card is not held to a bit-exact replay, as cuBLAS runs "
            f"without a fixed workspace and the embedding's backward adds "
            f"atomically; the CPU replays bit for bit); "
            f"final loss {second['last_loss']:.6f}")

        step_ms = [ms for ms, _ in tap.steps[1:]]
        med = statistics.median(step_ms)
        opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=20)  # launch.train's
        step = make_train_step(cfg, opt_cfg)
        batch = pipeline.TokenPipeline(cfg, pipeline.DataConfig(
            global_batch=TRAIN_B, seq_len=TRAIN_S)).batch_at(0)
        params, opt_state = tap2.last
        busy, n_kernels = busy_ms(lambda: step(params, opt_state, batch,
                                               device=cuda))
        by_dt = flops_by_dtype(lambda: step(params, opt_state, batch,
                                            device=cuda))
        ops = sum(by_dt.values())
        bound = ops / BF16_TC_OPS_PER_S * 1e3
        f32 = by_dt.get(torch.float32, 0)
        bound_dt = ((ops - f32) / BF16_TC_OPS_PER_S
                    + f32 / FP32_OPS_PER_S) * 1e3
        log("train", f"{cfg.name} B={TRAIN_B} S={TRAIN_S} on {card}: "
            f"{med:.2f} ms a step (median of steps 1-{TRAIN_STEPS - 1}: "
            f"{', '.join(f'{x:.2f}' for x in step_ms)}; step 0 "
            f"{tap.steps[0][0]:.2f} ms); {TRAIN_B * TRAIN_S / med * 1e3:.0f} "
            f"tokens/s; {n_kernels} kernels and copies a step, the card busy "
            f"{busy:.2f} ms (torch.profiler; idle share {1 - busy / med:.3f}"
            f"); {ops:.4g} operations a step (FlopCounterMode: forward, "
            f"the layers' and chunks' recompute and backward), bound "
            f"{bound:.2f} ms at {BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 "
            f"({med / bound:.1f}x); by dtype {f32:.4g} of them float32 (the "
            f"chunked attention's products) at "
            f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s, the rest bf16: bound "
            f"{bound_dt:.2f} ms ({med / bound_dt:.1f}x); peak memory {peak} "
            f"bytes above the {base} earlier phases hold "
            f"(torch.cuda.max_memory_allocated)")
        stages = train_stages(cuda, api.build(cfg), opt_cfg, params,
                              opt_state, batch)
        top = top_kernels(lambda: step(params, opt_state, batch,
                                       device=cuda))
        log("train", f"where a step's time goes on {card}: {stages}; the "
            f"card's top kernels in one step: {top}")
        del params, opt_state, state, first, second
        tap.last = tap2.last = None
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    cfg32 = cfg.scaled(dtype="float32")
    log("train", f"{cfg.name} float32 B=1 S={TRAIN_CPU_S}, one step card vs "
        f"CPU: {train_card_vs_cpu(cuda, cfg32, 1, TRAIN_CPU_S)}")

    smoke = configs.get_smoke(TRAIN_ARCH).scaled(vocab_size=128)
    opt_cfg = optim.AdamWConfig(lr=3e-3, warmup_steps=5, weight_decay=0.0)
    params = api.build(smoke).init(torch.Generator().manual_seed(0),
                                   device=cuda)
    opt_state = optim.init(opt_cfg, params, device=cuda)
    data = pipeline.TokenPipeline(smoke, pipeline.DataConfig(global_batch=4,
                                                             seq_len=64))
    step = make_train_step(smoke, opt_cfg)
    smoke_losses = []
    for i in range(SMOKE_STEPS):
        params, opt_state, m = step(params, opt_state, data.batch_at(i),
                                    device=cuda)
        smoke_losses.append(m["loss"].item())
    check(smoke_losses[-1] < smoke_losses[0] - 0.5, f"smoke loss "
          f"{smoke_losses[0]:.4f} -> {smoke_losses[-1]:.4f}: did not fall by "
          f"more than 0.5")
    log("train", f"{smoke.name} (vocab 128, lr 3e-3, warmup 5) on the card: "
        f"loss {smoke_losses[0]:.4f} -> {smoke_losses[-1]:.4f} in "
        f"{SMOKE_STEPS} steps on Markov data (must fall by more than 0.5)")

    launched = {k: v for k, v in _build.launches.items() if v}
    check(not launched, f"the training path launched kernels: {launched}")
    log("train", f"kernel launches on the training path: 0 of K1-K5 "
        f"({dict(_build.launches)}): the reference's models call the plain "
        f"chunked_attention and K5 has no backward pass; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


SHARD_STEPS = 3            # build_train steps, each held to make_train_step
SHARD_B, SHARD_S, SHARD_CTX = 8, 192, 256   # Qwen3 serving: prompt, cache
SHARD_DECODE = 8           # Qwen3 decode steps on each mesh
SHARD_CUT = {"deepseek_v2_236b": {"n_layers": 2},       # of 60, as run_moe
             "whisper_large_v3": {"n_layers": 2, "encoder_layers": 2}}
SHARD_CUT_B, SHARD_CUT_S = 4, 64   # B*S within DeepSeek's moe_group (P15)
SHARD_CUT_DECODE = 2


def _same(a, b) -> bool:
    """Every leaf of two trees (dicts, lists, tensors) torch.equal, dtypes
    included."""
    from repro_torch.models import lm
    la = lm.leaves(a) if isinstance(a, dict) else list(a)
    lb = lm.leaves(b) if isinstance(b, dict) else list(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _serve_steps(prefill, decode, params, batch, toks, cache, n: int):
    """A prefill, then ``n`` decode steps fed the given tokens:
    (logits of every call, the cache, ms of the prefill and each decode
    step on the host clock, the card synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [prefill(params, batch, cache)[0]]
    torch.cuda.synchronize()
    ms = [(time.perf_counter() - t0) * 1e3]
    S = batch["tokens"].shape[1]
    B = toks.shape[0]
    for i in range(n):
        t0 = time.perf_counter()
        logits.append(decode(params, toks[:, S + i:S + i + 1],
                             torch.full((B,), S + i, dtype=torch.int32,
                                        device=toks.device), cache)[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return logits, cache, ms


def run_sharded(cuda: torch.device) -> None:
    """The sharded steps (``launch.steps.build_{train,prefill,decode}``,
    ``dist.sharding``, ``dist.ctx.constrain``) with their own launch
    counts: Qwen3-0.6B whole in bf16 takes ``SHARD_STEPS`` train steps
    through ``build_train`` on ``make_local_mesh()``, every parameter,
    moment and metric torch.equal to ``make_train_step`` without a mesh
    from the same start; Qwen3 prefills and decodes through
    ``build_prefill``/``build_decode`` on the local mesh and on a (2, 2)
    ``("data", "model")`` mesh that names the card four times (the chunked
    attention's head-sharded branch), and DeepSeek-V2 (2 of 60 layers) and
    Whisper-large-v3 (2 layers) at full width on the (2, 2) mesh, logits
    and every cache tensor torch.equal to ``models.api`` without a mesh;
    one dry-run cell (``dryrun.run_cell``); no launch of K1-K5."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.dist import ctx
    from repro_torch.kernels import _build
    from repro_torch.launch import cells, dryrun, mesh, steps
    from repro_torch.models import api
    from repro_torch.train import optim

    t_phase = time.perf_counter()
    card = card_line()
    _build.launches.clear()
    local = mesh.make_local_mesh()
    quad = ctx.Mesh(((cuda, cuda), (cuda, cuda)), ("data", "model"))

    # -- training: build_train against make_train_step --------------------
    cfg = configs.get(TRAIN_ARCH)
    oc = steps.opt_config(cfg)
    fn, _ = steps.build_train(TRAIN_ARCH, cells.Shape(
        "train_smoke", "train", TRAIN_S, TRAIN_B), local)
    check(fn.device == torch.empty(0, device=cuda).device,
          f"build_train on the local mesh runs on {fn.device}")
    data = pipeline.TokenPipeline(cfg, pipeline.DataConfig(
        global_batch=TRAIN_B, seq_len=TRAIN_S))
    p0 = api.build(cfg).init(torch.Generator(cuda).manual_seed(SEED),
                             device=cuda)
    s0 = optim.init(oc, p0, device=cuda)
    plain = steps.make_train_step(cfg, oc)
    runs = {}
    for name, step in (("make_train_step", lambda p, s, b: plain(
            p, s, b, device=cuda)), ("build_train", fn)):
        p, st, ms, metrics = p0, s0, [], []
        for i in range(SHARD_STEPS):
            batch = data.batch_at(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, m = step(p, st, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        runs[name] = (p, st, metrics, ms)
    (pa, sa, ma, msa), (pb, sb, mb, msb) = runs.values()
    check(_same(pa, pb) and _same(sa, sb) and all(
        _same(x, y) for x, y in zip(ma, mb)),
        "build_train differs from make_train_step")
    log("sharded", f"{cfg.name} whole in bf16 ({oc.moment_dtype} moments, "
        f"steps.opt_config), B={TRAIN_B} S={TRAIN_S}, {SHARD_STEPS} steps "
        f"from one start on {card}: build_train on make_local_mesh() = "
        f"make_train_step without a mesh bit for bit (every parameter, "
        f"moment and metric; losses "
        f"{[round(float(m['loss']), 6) for m in mb]}); ms a step "
        f"make_train_step {', '.join(f'{x:.2f}' for x in msa)}, "
        f"build_train {', '.join(f'{x:.2f}' for x in msb)}")
    del runs, pa, sa, pb, sb, p, st, p0, s0

    # -- serving: Qwen3 on both meshes, DeepSeek and Whisper on (2, 2) ------
    rng = np.random.default_rng(SEED)
    cases = [("qwen3_0_6b", {}, SHARD_B, SHARD_S, SHARD_CTX, SHARD_DECODE,
              {"local": local, "2x2": quad})]
    cases += [(a, ov, SHARD_CUT_B, SHARD_CUT_S, SHARD_CUT_S + SHARD_CUT_DECODE,
               SHARD_CUT_DECODE, {"2x2": quad}) for a, ov in SHARD_CUT.items()]
    for arch, ov, B, S, ctx_len, n, meshes in cases:
        full = configs.get(arch)
        cfg = full.scaled(**ov)
        model = api.build(cfg)
        params = model.init(torch.Generator(cuda).manual_seed(SEED),
                            device=cuda)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
            B, S + n)).astype(np.int32), device=cuda)
        batch = {"tokens": toks[:, :S]}
        if cfg.family == "encdec":
            batch["frames"] = torch.as_tensor(rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32),
                device=cuda).to(torch.bfloat16)
        plain = (lambda p, b, c: model.prefill(p, b, c, device=cuda),
                 lambda p, t, pos, c: model.decode(p, t, pos, c, device=cuda))
        built = {mname: (
            steps.build_prefill(arch, cells.Shape("p", "prefill", S, B), m,
                                overrides=ov or None)[0],
            steps.build_decode(arch, cells.Shape("d", "decode", ctx_len, B),
                               m, overrides=ov or None)[0])
            for mname, m in meshes.items()}
        # without a mesh first and last, so that neither side alone pays
        # the first call's warm-up
        order = [("api without a mesh", plain)] + [
            (f"{k} mesh", v) for k, v in built.items()] + [
            ("api without a mesh, again", plain)]
        line, want = [], None
        for what, (pf, dc) in order:
            got = _serve_steps(pf, dc, params, batch, toks,
                               model.init_cache(B, ctx_len, device=cuda), n)
            want = want or got
            check(_same(got[0], want[0]) and _same(got[1], want[1]),
                  f"{arch}: {what} differs from models.api")
            line.append(f"{what}: prefill {got[2][0]:.2f} ms, decode "
                        f"median {statistics.median(got[2][1:]):.2f} ms")
        heads = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} divide model=2: the "
                 f"chunked attention's head-sharded branch" if
                 cfg.n_heads % 2 == cfg.n_kv_heads % 2 == 0 else
                 "heads do not divide model=2")
        log("sharded", f"{cfg.name} at full width"
            f"{'' if not ov else f' ({ov} of {full.n_layers} layers)'}, "
            f"B={B}, prompt {S}, {n} decode steps, cache {ctx_len}: "
            f"build_prefill/build_decode on {', '.join(meshes)} = "
            f"models.api bit for bit (logits of every call, every cache "
            f"tensor; {heads}); {'; '.join(line)}")
        del params, want, got

    # -- one dry-run cell ----------------------------------------------------
    t0 = time.perf_counter()
    rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", multi_pod=False)
    rl = rec["roofline"]
    check(rec["status"] == "ok", f"dry run: {rec}")
    log("sharded", f"dryrun.run_cell(qwen3-0.6b, decode_32k, 16x16) in "
        f"{time.perf_counter() - t0:.2f} s (meta, no card): dominant "
        f"{rl['dominant']}, t_compute {rl['t_compute']:.6g} s, t_memory "
        f"{rl['t_memory']:.6g} s, t_collective {rl['t_collective']:.6g} s "
        f"per device (H100 SXM data sheet at 700 W), argument bytes "
        f"{rec['memory']['argument_bytes']} a device")

    launched = {k: v for k, v in _build.launches.items() if v}
    check(not launched, f"the sharded path launched kernels: {launched}")
    log("sharded", f"kernel launches on the sharded path: 0 of K1-K5 "
        f"({dict(_build.launches)}); phase took "
        f"{time.perf_counter() - t_phase:.1f} s")


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
    run_models(cuda)
    run_moe(cuda)
    run_ssm_encdec(cuda)
    run_train(cuda)
    run_sharded(cuda)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
