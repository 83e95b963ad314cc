"""Parity of the port's algorithm registry (``repro_torch.core.registry``)
with the JAX package's, on the CPU.

Inputs are the reference's own instance generators (``prefix.INSTANCES``
at 24x20, ``prefix.INSTANCES_3D`` at 16^3), made from a seed with NumPy;
the port's copies of the generators give the same arrays.  Every name
runs through both packages' ``registry.partition`` on the same Gamma (or
volume); the device-backed names of the port run with ``device="cpu"``.
Tolerance: none.  The loads are integers, and every name gives the same
rectangles (boxes in 3D), the same ``max_load`` and the same ``m_target``
as the reference, with ``speeds=`` too; where the reference raises (a
P x Q name at a non-square m), the port raises the same exception type.
HIER-OPT's exhaustive DP runs at 12x10 so the file stays fast.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import prefix as jax_prefix
from repro.core import registry as jax_reg
from repro_torch import obs
from repro_torch.core import prefix, registry

NAMES_2D = [n for n in jax_reg.names() if n not in jax_reg.RANK3]
NAMES_3D = sorted(jax_reg.RANK3)
ON_DEVICE = {n for n in jax_reg.names() if "device" in n or "sgorp" in n}
GENS = sorted(jax_prefix.INSTANCES)
GENS_3D = sorted(jax_prefix.INSTANCES_3D)


def _kw(name: str) -> dict:
    return {"device": "cpu"} if name in ON_DEVICE else {}


@functools.lru_cache(maxsize=None)
def _gamma(gen: str, shape: tuple) -> np.ndarray:
    return jax_prefix.prefix_sum_2d(jax_prefix.INSTANCES[gen](*shape, seed=1))


@functools.lru_cache(maxsize=None)
def _volume(gen: str) -> np.ndarray:
    return jax_prefix.INSTANCES_3D[gen](16, 16, 16, seed=2)


def _cells(part) -> list:
    items = part.boxes if hasattr(part, "boxes") else part.rects
    return [dataclasses.astuple(r) for r in items]


def _check_same(name: str, load, m: int, **kw) -> None:
    """Both registries on the same input: the same partition, or the same
    exception type."""
    try:
        want = jax_reg.partition(name, load, m, **kw)
    except (ValueError, KeyError) as e:
        with pytest.raises(type(e)):
            registry.partition(name, load, m, **kw, **_kw(name))
        return
    got = registry.partition(name, load, m, **kw, **_kw(name))
    assert _cells(got) == _cells(want)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.m_target == want.m_target
    assert got.max_load(load) == want.max_load(load)


def test_names_match_the_reference():
    assert registry.names() == jax_reg.names()
    assert registry.CAPACITY_AWARE == jax_reg.CAPACITY_AWARE
    assert registry.RANK3 == jax_reg.RANK3


@pytest.mark.parametrize("gen", GENS)
def test_generators_match_the_reference(gen):
    assert np.array_equal(prefix.INSTANCES[gen](24, 20, seed=1),
                          jax_prefix.INSTANCES[gen](24, 20, seed=1))
    np.testing.assert_array_equal(prefix.transpose_gamma(_gamma(gen, (24,
                                                                      20))),
                                  jax_prefix.transpose_gamma(
                                      _gamma(gen, (24, 20))))


@pytest.mark.parametrize("gen", GENS_3D)
def test_generators_3d_match_the_reference(gen):
    assert np.array_equal(prefix.INSTANCES_3D[gen](16, 16, 16, seed=2),
                          _volume(gen))


@pytest.mark.parametrize("gen", GENS)
@pytest.mark.parametrize("name", NAMES_2D)
def test_2d_name_matches_the_reference(name, gen):
    shape, ms = ((12, 10), (4, 6)) if name == "hier-opt" else ((24, 20),
                                                               (6, 16))
    for m in ms:
        _check_same(name, _gamma(gen, shape), m)


SPEED_GENS = ["peak", "slac", "uniform"]


def _speeds(name: str, m: int, seed: int) -> np.ndarray:
    sp = np.random.default_rng(seed).uniform(0.25, 4.0, m)
    if "sgorp" not in name:   # sgorp's fixed grid takes positive speeds only
        sp[[1, m - 2]] = 0.0
    return sp


@pytest.mark.parametrize("name", sorted(jax_reg.CAPACITY_AWARE))
def test_speeds_match_the_reference(name):
    """The capacity-aware names with heterogeneous speeds (two dead parts
    where the algorithm allows them): the same rectangles, so the same
    relative bottleneck."""
    if name in jax_reg.RANK3:
        for gen in GENS_3D:
            _check_same(name, _volume(gen), 8, speeds=_speeds(name, 8, 3))
        return
    for gen in SPEED_GENS:
        for m in (6, 16):
            _check_same(name, _gamma(gen, (24, 20)), m,
                        speeds=_speeds(name, m, m))


@pytest.mark.parametrize("gen", GENS_3D)
@pytest.mark.parametrize("name", NAMES_3D)
def test_rank3_name_matches_the_reference(name, gen):
    for m in (8, 12):
        _check_same(name, _volume(gen), m)


@pytest.mark.parametrize("name,load,kw", [
    ("jag-m-heur", "volume", {}),
    ("jag-m-heur-3d", "gamma", {}),
    ("rect-nicol", "gamma", {"speeds": [1, 2, 1, 1, 3, 1]}),
    ("hier-rb", "gamma", {"speeds": [1, 2, 1, 1, 3, 1]}),
    ("jag-m-opt-device", "gamma", {"speeds": [1, 2, 1, 1, 3, 1]}),
    ("no-such-algorithm", "gamma", {}),
    ("jag-pq-opt-device", "gamma", {}),     # m = 6 is not square
])
def test_errors_match_the_reference(name, load, kw):
    """A rank mismatch, speeds on a name that is not capacity-aware, an
    unknown name and a P x Q name at a non-square m raise the same
    exception type in both packages."""
    x = _volume("pic3d") if load == "volume" else _gamma("peak", (24, 20))
    with pytest.raises((ValueError, KeyError)) as want:
        jax_reg.partition(name, x, 6, **kw)
    with pytest.raises(want.type):
        registry.partition(name, x, 6, **kw, **_kw(name))


@pytest.mark.parametrize("name", [
    "rect-nicol", "jag-pq-opt", "jag-m-heur-probe", "jag-m-opt",
    "hier-relaxed", "hybrid", "jag-pq-opt-device", "jag-m-opt-device",
    "sgorp-2d", "jag-m-heur-3d", "project-then-2d"])
def test_explain_matches_the_reference(name):
    """``explain`` gives the same bottleneck, ideal, imbalance and engine
    counters (timings are not compared), and its spans hold the
    partition's own."""
    x = _volume("amr3d") if name in jax_reg.RANK3 else _gamma("multipeak",
                                                              (24, 20))
    want = jax_reg.explain(name, x, 16)
    got = registry.explain(name, x, 16, **_kw(name))
    assert isinstance(got, obs.PartitionReport)
    for f in ("algo", "m", "shape", "bottleneck", "ideal", "imbalance",
              "counters"):
        assert getattr(got, f) == getattr(want, f), f
    assert _cells(got.partition) == _cells(want.partition)
    assert f"partition.{name}" in {ev["name"] for ev in got.spans}
    assert set(got.to_dict()) == set(want.to_dict())
    assert got.summary().split(" (")[0] == want.summary().split(" (")[0]


def test_explain_nests_in_an_outer_recording():
    g = _gamma("peak", (24, 20))
    with obs.tracing() as tr:
        with obs.span("outer"):
            rep = registry.explain("jag-m-heur", g, 16)
    names = [ev["name"] for ev in tr.events()]
    assert "outer" in names and "partition.jag-m-heur" in names
    assert rep.bottleneck == jax_reg.explain("jag-m-heur", g, 16).bottleneck
