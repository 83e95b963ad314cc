"""The port stands alone and never falls back.

- ``repro_torch`` and ``chip_smoke.py`` import without ``jax`` and without
  ``repro`` (a subprocess where importing either fails), and the planner,
  the rebalance runtime, the capacity-aware planner and the serve
  simulator run there on the CPU;
- an entry point with no ``device=`` raises where CUDA is absent instead
  of running on the CPU;
- no ``except`` clause and no environment read in the port or the smoke
  script can route a CUDA tensor to a plain version, and only a kernel's
  own wrapper (and the smoke script's comparisons) import its plain
  version.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import prefix, registry, sgorp
from repro_torch.dist import ctx
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.probe import ops as probe_ops
from repro_torch.kernels.rectload import ops as rl_ops
from repro_torch.kernels.sat import ops as sat_ops
from repro_torch.rebalance import (batch_device, execute, planner, policy,
                                   runtime, stream)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_ISOLATED = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from repro_torch.rebalance import planner, stream
fr = stream.drifting_hotspot(2, 24, 32, seed=0)
for exact in (False, True):
    plans = planner.plan_host(fr, P=2, m=4, exact=exact, device="cpu")
    assert len(plans) == 2
from repro_torch.rebalance import faults, policy, runtime
from repro_torch.core import prefix
res = runtime.run_stream(stream.drifting_hotspot(6, 24, 24, seed=0),
                         policy.FaultAwareHysteresis(), P=2, m=8,
                         faults=faults.rack_failure(6, 8), execute=True,
                         validate=True, device="cpu")
assert res.n_forced == 1 and all(r.executed_bytes == r.migration_volume
                                 for r in res.records[1:] if r.replanned)
sp = [1.0] * 7 + [0.0]
assert faults.capacity_plan(prefix.prefix_sum_2d(fr[0]), P=2, m=8,
                            speeds=sp).m == 8
from repro_torch.serve import simulate
sim = simulate.simulate(simulate.poisson_arrivals(200, rate=50.0, seed=0),
                        n_replicas=3, service_rate=2000.0, tick=0.1,
                        policy=policy.TwoPhaseHysteresis())
assert sim.completed == sim.admitted == 200
vol = stream.pic_series_3d(2, 8, 8, 8, seed=0)
assert len(planner.plan_stream(vol, P=0, m=8, device="cpu")) == 6
import torch
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import layers
q = torch.randn(1, 9, 2, 8)
pos = torch.arange(9)[None]
assert torch.allclose(flash_ops.attention(q, q, q), layers.chunked_attention(
    q, q, q, pos, pos, causal=True, window=0, softcap=0.0, scale=8 ** -0.5,
    q_chunk=4, kv_chunk=4), atol=1e-5)
import numpy as np
from repro_torch.dist import cp_balance, ctx, moe_placement
assert cp_balance.balanced_plan(64, 8)[-1] == 64
counts = moe_placement.simulate_router_counts(8, 12, seed=0)
assert moe_placement.plan_expert_placement(counts, 6).partition.is_valid()
mesh = ctx.planner_mesh(devices=["cpu"] * 3)
for exact in (False, True):
    one = planner.plan_stream(fr, P=2, m=4, exact=exact, device="cpu")
    three = planner.plan_stream(fr, P=2, m=4, exact=exact, mesh=mesh)
    assert all(torch.equal(a, b) for a, b in zip(one, three))
res3 = runtime.run_stream(stream.drifting_hotspot(6, 24, 24, seed=0),
                          policy.AlwaysRebalance(), P=2, m=8, devices=2,
                          execute=True, execute_devices=["cpu"] * 3,
                          device="cpu")
assert all(r.executed_bytes == r.migration_volume for r in res3.records[1:])
leaked = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not leaked, leaked
print("imported", len(names))
"""


def test_port_imports_and_plans_without_jax_or_repro():
    r = subprocess.run([sys.executable, "-c", _ISOLATED], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 35


def _entry_points():
    fr = stream.static(2, 16, 16)
    vol = stream.amr_series_3d(2, 8, 8, 8)
    plan = planner.plan_host(fr, P=2, m=4, device="cpu")[0]
    return [
        lambda: planner.plan_stream(fr, P=4, m=16),
        lambda: planner.plan_host(fr, P=4, m=16),
        lambda: list(planner.plan_iter(fr, P=4, m=16)),
        lambda: planner.profile_stages(fr, P=4, m=16),
        lambda: batch_device.plan_stream(fr, P=4, m=16, exact=True),
        lambda: batch_device.gamma_batch(fr),
        lambda: batch_device.jag_m_heur_batch(np.zeros((1, 5, 5)), P=2, m=4),
        lambda: execute.plan_rect_loads(plan, fr[0]),
        lambda: execute.execute_migration(plan, plan, fr[0]),
        lambda: planner.plan_stream(vol, P=0, m=8),
        lambda: planner.plan_stream_3d(vol, m=8),
        lambda: sgorp.sgorp_2d(np.arange(25).reshape(5, 5), 4),
        lambda: sgorp.sgorp_3d(vol[0], 8),
        lambda: runtime.run_stream(fr, policy.NeverRebalance(), P=2, m=4),
        lambda: runtime.compare_policies(
            fr, {"never": policy.NeverRebalance()}, P=2, m=4),
        lambda: runtime.plan_stream_host(fr, P=2, m=4),
        lambda: ctx.planner_mesh(),
        lambda: runtime.plan_stream_host(fr, P=2, m=4, devices=2),
        lambda: runtime.run_stream(fr, policy.NeverRebalance(), P=2, m=4,
                                   mesh=ctx.planner_mesh(
                                       devices=["cuda"] * 2)),
        lambda: execute.execute_migration(plan, plan, fr[0],
                                          devices=["cuda"] * 2),
    ]


@pytest.mark.parametrize("i", range(20))
def test_entry_points_raise_without_cuda(i, monkeypatch):
    call = _entry_points()[i]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


DEVICE_NAMES = sorted(n for n in registry.names()
                      if "device" in n or "sgorp" in n)


@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_registry_device_names_raise_without_cuda(name, monkeypatch):
    """Each device-backed registry name, called without ``device=``,
    raises where CUDA is absent; the host names run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    load = (np.arange(512).reshape(8, 8, 8) if name in registry.RANK3
            else prefix.prefix_sum_2d(np.arange(64).reshape(8, 8)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.partition(name, load, 4)
    assert registry.partition("jag-pq-opt", prefix.prefix_sum_2d(
        np.arange(64).reshape(8, 8)), 4).m == 4


_REGISTRY_ISOLATED = f"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{str(ROOT / 'src')!r}]
from repro_torch.core import prefix, registry
g = prefix.prefix_sum_2d(prefix.peak_instance(12, 10, seed=0))
vol = prefix.pic_like_instance_3d(8, 8, 8, seed=0)
for name in registry.names():
    kw = {{"device": "cpu"}} if "device" in name or "sgorp" in name else {{}}
    m = 4 if name != "hier-opt" else 3
    part = registry.partition(name, vol if name in registry.RANK3 else g, m,
                              **kw)
    assert part.m == m, name
print(registry.explain("jag-pq-opt-device", g, 4, device="cpu").summary())
leaked = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not leaked, leaked
print("partitioned", len(registry.names()))
"""


def test_registry_runs_without_jax_or_repro():
    r = subprocess.run([sys.executable, "-c", _REGISTRY_ISOLATED],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) == 46


@pytest.mark.parametrize("call", [
    lambda t: sat_ops.gamma(t((3, 4), torch.int32)),
    lambda t: sat_ops.gamma3(t((3, 4, 5), torch.float32)),
    lambda t: probe_ops.probe_counts(t((2, 5), torch.int32),
                                     t((2, 3), torch.int32), 2),
    lambda t: rl_ops.jagged_loads(t((5, 5), torch.float32),
                                  t((3,), torch.int32), t((2, 3), torch.int32)),
    lambda t: flash_ops.attention(t((1, 6, 2, 16), torch.bfloat16),
                                  t((1, 9, 2, 16), torch.bfloat16),
                                  t((1, 9, 2, 16), torch.bfloat16)),
])
def test_wrappers_take_only_cpu_or_cuda(call):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(lambda shape, dt: torch.zeros(shape, dtype=dt, device="meta"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("q,k,v,error,match", [
    ((4, 8, 257), (4, 8, 257), (4, 8, 257), ValueError, "head dim 257"),
    ((4, 8, 16), (4, 8, 16), (4, 8, 16, torch.bfloat16), TypeError,
     "float32 or all bfloat16"),
    ((4, 8, 16, torch.float16), (4, 8, 16, torch.float16),
     (4, 8, 16, torch.float16), TypeError, "float32 or all bfloat16"),
    ((4, 8, 16), (4, 9, 16), (4, 8, 16), ValueError, "their length"),
    ((4, 8, 16), (4, 8, 32), (4, 8, 32), ValueError, "share BH and d"),
])
def test_flash_wrapper_rejects(device, q, k, v, error, match):
    """The flash wrapper refuses what the kernel does not take, on every
    device: d above 256, mixed dtypes, float16, k and v of other lengths,
    another head dim."""
    def t(spec):
        dt = spec[3] if len(spec) == 4 else torch.float32
        return torch.zeros(spec[:3], dtype=dt, device=device)

    with pytest.raises(error, match=match):
        flash_ops.flash_attention(t(q), t(k), t(v))


def test_flash_wrapper_needs_contiguous_tensors():
    q = torch.zeros(4, 16, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q, q, q)


def test_no_fallback_sources_cover_the_port():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES[:-1]}
    assert {"kernels/flash/ops.py", "kernels/flash/ref.py",
            "models/layers.py", "kernels/_build.py", "rebalance/policy.py",
            "rebalance/faults.py", "rebalance/runtime.py", "obs/hist.py",
            "serve/__init__.py", "serve/queue.py", "serve/batcher.py",
            "serve/simulate.py", "dist/__init__.py", "dist/ctx.py",
            "dist/cp_balance.py", "dist/moe_placement.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_fallback_routes(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.Try) and node.handlers), \
            f"{path}:{node.lineno}: an except clause could hide a kernel"
        if isinstance(node, ast.Attribute) and node.attr in ("environ",
                                                             "getenv"):
            raise AssertionError(f"{path}:{node.lineno}: environment read")
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "ref" or node.module.endswith(".ref")):
            assert path.name in ("ops.py", "chip_smoke.py"), \
                f"{path}:{node.lineno}: imports a plain version"
        if isinstance(node, ast.Import):
            assert not any(a.name.split(".")[0] in ("jax", "repro")
                           for a in node.names), f"{path}: imports JAX"
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] not in ("jax", "repro"), \
                f"{path}:{node.lineno}: imports {node.module}"
