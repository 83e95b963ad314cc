"""The port's sharding specs and logical-axis resolution
(``repro_torch.dist.{ctx,sharding}``, ``train.optim.state_specs``)
against the JAX package's, on the CPU.

Specs are pure shape and axis arithmetic, so every comparison is exact:
the same leaves at the same paths with the same shapes, and each spec's
entries (``tuple(spec)``) equal to the reference's ``PartitionSpec``'s.
The reference's shapes come from ``jax.eval_shape`` (its ``api.*_spec``
functions), the port's from ``meta`` stand-ins: no weights are made.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jax_configs
from repro.dist import ctx as jax_ctx
from repro.dist import sharding as jax_shd
from repro.launch import cells as jax_cells
from repro.models import api as jax_api
from repro.train import optim as jax_optim
from repro_torch import configs
from repro_torch.dist import ctx, sharding
from repro_torch.launch import cells, roofline, steps
from repro_torch.models import api
from repro_torch.train import optim

from _torch_models_parity import paths

ARCHS = configs.ARCHS
PRODUCTION = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _random_meshes(seed: int, n: int = 8):
    """``n`` meshes with the reference test's ranges: pod in 1-3 (pod 1
    gives the two-axis mesh), data and model in 1-12."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pod, data, model = (int(rng.integers(1, 4)),
                            *(int(x) for x in rng.integers(1, 13, 2)))
        out.append(((data, model), ("data", "model")) if pod == 1 else
                   ((pod, data, model), ("pod", "data", "model")))
    return out


def _same_specs(port_specs, port_tree, ref_specs, ref_tree, what):
    """The same paths and shapes, and equal entries at every leaf."""
    ps, pt = paths(port_specs), paths(port_tree)
    rs, rt = paths(ref_specs), paths(ref_tree)
    assert set(ps) == set(rs) == set(pt) == set(rt), what
    for k in ps:
        assert tuple(pt[k].shape) == tuple(rt[k].shape), (what, k)
        assert isinstance(ps[k], ctx.PartitionSpec), (what, k)
        assert tuple(ps[k]) == tuple(rs[k]), (what, k, ps[k], rs[k])


def _both_specs(jcfg, tcfg, jmesh, tmesh, B, S, what):
    """param (both fsdp), batch and cache specs of both packages."""
    jp, tp = jax_api.param_spec(jcfg), api.param_spec(tcfg)
    for fsdp in (True, False):
        _same_specs(sharding.param_specs(tcfg, tmesh, tp, fsdp=fsdp), tp,
                    jax_shd.param_specs(jcfg, jmesh, jp, fsdp=fsdp), jp,
                    f"{what} params fsdp={fsdp}")
    jb = jax_api.train_batch_spec(jcfg, B, S)
    tb = api.train_batch_spec(tcfg, B, S)
    _same_specs(sharding.batch_specs(tcfg, tmesh, tb), tb,
                jax_shd.batch_specs(jcfg, jmesh, jb), jb, f"{what} batch")
    jc, tc = jax_api.cache_spec(jcfg, B, S), api.cache_spec(tcfg, B, S)
    _same_specs(sharding.cache_specs(tcfg, tmesh, tc), tc,
                jax_shd.cache_specs(jcfg, jmesh, jc), jc, f"{what} cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_on_random_meshes(arch):
    """Every smoke config on eight random abstract meshes (the ranges of
    ``tests/test_dist_invariants.py::test_sharding_specs_divide_on_random_
    meshes``), batch 8 x 64: the port's specs are the reference's."""
    jcfg, tcfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    for shape, axes in _random_meshes(ARCHS.index(arch)):
        _both_specs(jcfg, tcfg, jax_ctx.abstract_mesh(shape, axes),
                    ctx.abstract_mesh(shape, axes), 8, 64, f"{shape}")


@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_on_production_meshes(arch, mesh):
    """Every full config on both production meshes, at each shape's batch
    and length of the cell grid."""
    shape, axes = PRODUCTION[mesh]
    jcfg, tcfg = jax_configs.get(arch), configs.get(arch)
    for sh in cells.SHAPES.values():
        _both_specs(jcfg, tcfg, jax_ctx.abstract_mesh(shape, axes),
                    ctx.abstract_mesh(shape, axes), sh.global_batch,
                    sh.seq_len, f"{mesh} {sh.name}")


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16"},
                                {"compress_grads": True}])
def test_state_specs_match(kw):
    """``optim.state_specs``: the moments (and ``err``) as the parameter
    specs, the step replicated: ``P()`` as the reference's."""
    jcfg, tcfg = jax_configs.get_smoke("qwen3_0_6b"), \
        configs.get_smoke("qwen3_0_6b")
    jm = jax_ctx.abstract_mesh((2, 4), ("data", "model"))
    tm = ctx.abstract_mesh((2, 4), ("data", "model"))
    jp, tp = jax_api.param_spec(jcfg), api.param_spec(tcfg)
    want = jax_optim.state_specs(jax_shd.param_specs(jcfg, jm, jp),
                                 jax_optim.AdamWConfig(**kw))
    got = optim.state_specs(sharding.param_specs(tcfg, tm, tp),
                            optim.AdamWConfig(**kw))
    assert set(got) == set(want)
    assert got["step"] == ctx.P() and tuple(want["step"]) == ()
    for k in got:
        if k != "step":
            _same_specs(got[k], tp, want[k], jp, k)


# ---------------------------------------------------------------------------
# ctx: meshes, resolution, the hint


def test_partition_spec_entries_match():
    for entries in [(), (None,), ("data", None), (("pod", "data"), "model"),
                    (None, ("pod", "data"), None, "model")]:
        assert tuple(ctx.P(*entries)) == tuple(JP(*entries)) == entries
    assert ctx.PartitionSpec is ctx.P
    assert repr(ctx.P("data", None)) == "PartitionSpec('data', None)"


def test_abstract_mesh():
    """``abstract_mesh``: axis names and sizes, no devices; ``mesh_sizes``,
    ``dp_axes`` and ``planner_axes`` take it as they take a ``Mesh``, and
    as the reference's take its ``AbstractMesh``."""
    for shape, axes in [((2, 4, 3), ("pod", "data", "model")),
                        ((4, 3), ("data", "model")), ((5,), ("model",))]:
        m, jm = ctx.abstract_mesh(shape, axes), jax_ctx.abstract_mesh(
            shape, axes)
        assert m.shape == dict(jm.shape) == ctx.mesh_sizes(m)
        assert list(m.shape) == list(axes) and m.axis_names == axes
        assert ctx.dp_axes(m) == jax_ctx.dp_axes(jm)
        if ctx.dp_axes(m):
            assert ctx.planner_axes(m) == jax_ctx.planner_axes(jm)
    with pytest.raises(ValueError, match="no data-parallel axis"):
        ctx.planner_axes(ctx.abstract_mesh((5,), ("model",)))
    with pytest.raises(ValueError, match="2 sizes"):
        ctx.abstract_mesh((2, 4), ("data",))
    with pytest.raises(ValueError, match="positive"):
        ctx.abstract_mesh((0, 4), ("data", "model"))


def test_ctx_resolve_and_mesh_context():
    """``tests/test_dist_invariants.py::test_ctx_resolve_and_mesh_context``
    on the port, each resolution also held to the reference's."""
    cases = [(((2, 4, 3), ("pod", "data", "model")), ("dp", None, "model"),
              (16, 5, 9), (("pod", "data"), None, "model")),
             (((2, 4, 3), ("pod", "data", "model")), ("dp", "model"),
              (12, 5), (None, None)),
             (((4, 3), ("data", "model")), ("dp", "model"), (12, 9),
              ("data", "model"))]
    for (shape, axes), spec, dims, want in cases:
        got = ctx.resolve(ctx.abstract_mesh(shape, axes), spec, shape=dims)
        ref = jax_ctx.resolve(jax_ctx.abstract_mesh(shape, axes), spec,
                              shape=dims)
        assert isinstance(got, ctx.PartitionSpec)
        assert tuple(got) == tuple(ref) == want
    mesh = ctx.abstract_mesh((2, 4, 3), ("pod", "data", "model"))
    single = ctx.abstract_mesh((4, 3), ("data", "model"))
    # no shape: nothing dropped; an axis the mesh lacks resolves to None
    assert tuple(ctx.resolve(single, ("dp", "pod", "model"))) == \
        tuple(jax_ctx.resolve(jax_ctx.abstract_mesh((4, 3), (
            "data", "model")), ("dp", "pod", "model"))) == \
        ("data", None, "model")
    assert ctx.current_mesh() is None
    with ctx.mesh_context(mesh) as m:
        assert ctx.current_mesh() is m
        with ctx.mesh_context(single):
            assert ctx.current_mesh() is single
        assert ctx.current_mesh() is m
    assert ctx.current_mesh() is None


def test_constrain_returns_x():
    """``constrain`` returns its argument itself, with no mesh (the
    reference's identity, a NumPy array included) and with one (the
    reference pins the sharding, which changes no value); with a mesh a
    spec longer than the tensor raises."""
    x = np.arange(6.0).reshape(2, 3)
    assert ctx.constrain(x, "dp", "model") is x
    t = torch.arange(24.0).reshape(4, 6)
    assert ctx.constrain(t, "dp", "model", None) is t    # no mesh: no check
    for mesh in (ctx.abstract_mesh((2, 3), ("data", "model")),
                 ctx.Mesh((("cpu",) * 3,) * 2, ("data", "model"))):
        with ctx.mesh_context(mesh):
            assert ctx.constrain(t, "dp", "model") is t
            assert ctx.constrain(t, None, None) is t
            with pytest.raises(ValueError, match="3 entries"):
                ctx.constrain(t, "dp", "model", None)


# ---------------------------------------------------------------------------
# per-device argument bytes


def _ref_arg_bytes(arch: str, shape, mesh) -> int:
    """The reference's per-device argument bytes of a cell: its builders'
    input specs (``repro.launch.steps.build_*``) applied to its
    ``ShapeDtypeStruct`` stand-ins."""
    cfg = jax_configs.get(arch)
    sizes = dict(mesh.shape)
    pspec = jax_api.param_spec(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        big = jax_api.count_params(cfg) > 1e11
        oc = jax_optim.AdamWConfig(moment_dtype="bfloat16" if big
                                   else "float32")
        p_sh = jax_shd.param_specs(cfg, mesh, pspec)
        batch = jax_api.train_batch_spec(cfg, B, S)
        args = [(pspec, p_sh),
                (jax.eval_shape(lambda p: jax_optim.init(oc, p), pspec),
                 jax_optim.state_specs(p_sh, oc)),
                (batch, jax_shd.batch_specs(cfg, mesh, batch))]
    else:
        p_sh = jax_shd.param_specs(cfg, mesh, pspec,
                                   fsdp=cfg.serve_fsdp_params)
        cspec = jax_api.cache_spec(cfg, B, S)
        c_sh = jax_shd.cache_specs(cfg, mesh, cspec)
        if shape.kind == "prefill":
            batch = jax_api.prefill_batch_spec(cfg, B, S)
            args = [(pspec, p_sh), (batch, jax_shd.batch_specs(cfg, mesh,
                                                               batch)),
                    (cspec, c_sh)]
        else:
            toks, pos = jax_api.decode_inputs_spec(cfg, B)
            args = [(pspec, p_sh),
                    (toks, jax_shd.batch_specs(cfg, mesh, {"t": toks})["t"]),
                    (pos, jax_shd.batch_specs(cfg, mesh, {"p": pos})["p"]),
                    (cspec, c_sh)]
    total = 0
    for tree, specs in args:
        leaves, sp = paths(tree), paths(specs)
        for k, leaf in leaves.items():
            k_sh = 1
            for e in tuple(sp[k]):
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    k_sh *= sizes[a]
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // k_sh
    return total


@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_on_production_meshes(arch, mesh):
    """Per device, the bytes of every cell's arguments under the port's
    ``launch.steps.build_cell`` specs (``roofline.memory_summary``) equal
    the same arithmetic on the reference's specs."""
    shape, axes = PRODUCTION[mesh]
    for name, sh in cells.SHAPES.items():
        fn, args = steps.build_cell(arch, name, ctx.abstract_mesh(shape,
                                                                  axes))
        got = roofline.memory_summary(fn, args, sh)["argument_bytes"]
        want = _ref_arg_bytes(arch, jax_cells.SHAPES[name],
                              jax_ctx.abstract_mesh(shape, axes))
        assert got == want, (name, got, want)
