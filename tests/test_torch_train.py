"""The port's training path (``train.optim``, ``train.checkpoint``,
``data.pipeline``, ``launch.{cells,mesh,steps,train}`` and the
multi-axis ``dist.ctx.Mesh``) against the JAX package, on the CPU, and
the reference's own training tests (``tests/test_train.py``) on the port.

Tolerances:
- one AdamW step (``optim.apply``) from identical parameters, gradients
  and state at float32: the new parameters, moments, ``grad_norm`` and
  ``lr`` within ``OPT_TOL`` = 1e-6 x the leaf's max |reference| (a few
  ulps: XLA fuses some multiply-adds); the compression residual ``err``
  within 1e-6 x max |gradient| (XLA computes ``g - q * scale`` in one
  fused multiply-add, the port in two roundings).  At bf16 the parameters
  are equal; with compression (P21), XLA keeps the dequantised bf16
  gradient in float32 inside its fusion, so ``grad_norm`` and the moments
  are held to ``BF16_COMPRESS_TOL`` = 1e-3 relative and the parameters to
  one bf16 step (2**-8 x the leaf's max);
- ``_schedule``, ``compress_decompress`` on its own, the pipelines and
  the cells: bit for bit;
- three train steps from the same carried-over state (the reference's
  parameters and AdamW state through ``params_from_numpy`` and
  ``state_from_numpy``) at float32: the loss within 1e-5 relative, every
  parameter leaf within ``STEP_TOL`` = 1e-4 x its max |reference| (the
  gradients agree to about 1e-6, see ``test_torch_loss.py``);
- checkpoints: leaves bit for bit, across the packages too; a resumed run
  equal to the uninterrupted one bit for bit.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.data import pipeline as jax_pipeline
from repro.launch import cells as jax_cells
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.train import checkpoint as jax_ckpt
from repro.train import optim as jax_optim
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import ctx
from repro_torch.launch import cells, mesh, train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api, lm
from repro_torch.train import checkpoint, optim

from _torch_models_parity import CPU, both_params, host, paths

OPT_TOL, BF16_COMPRESS_TOL, STEP_TOL = 1e-6, 1e-3, 1e-4
#: a parameter tree with the leaves P20 is about: a stacked per-layer norm
#: scale (L, d), which is decayed, and the final norm's (d,), which is not
SHAPES = {"embed": (32, 8), "ln_f": (8,),
          "layers": {"ln1": (3, 8), "w": (3, 8, 4)}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU ops, restored after each test:
    they are small, so one thread runs them faster than a pool, and far
    faster where several pytest workers share the cores (a pool's threads
    then wait on each other at every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _close(got, want, tol, what):
    """Every leaf within ``tol`` x its max |want|."""
    got, want = paths(got), paths(want)
    assert set(got) == set(want), what
    for k in want:
        a, b = host(got[k]), host(want[k])
        assert a.shape == b.shape, (what, k)
        err = float(np.abs(a - b).max())
        assert err <= tol * float(np.abs(b).max()), \
            f"{what}{k}: max|d| {err:.3g}"


# ---------------------------------------------------------------------------
# optim


def test_schedule_matches():
    """The warmup schedule, bit for bit, over steps 0..40 of three configs
    (float32 division of the int32 step)."""
    steps = np.arange(41, dtype=np.int32)
    for kw in ({}, {"lr": 3e-3, "warmup_steps": 5},
               {"lr": 1e-3, "warmup_steps": 0}):
        want = np.asarray(jax_optim._schedule(jax_optim.AdamWConfig(**kw),
                                              jnp.asarray(steps)))
        got = optim._schedule(optim.AdamWConfig(**kw), torch.tensor(steps))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_gradient_compression_roundtrip():
    """``tests/test_train.py::test_gradient_compression_roundtrip`` on the
    port: the residual is carried, not lost."""
    g = torch.tensor(np.random.default_rng(0).standard_normal(100),
                     dtype=torch.float32)
    err = torch.zeros_like(g)
    deq, new_err = optim.compress_decompress(g, err)
    np.testing.assert_allclose((deq + new_err).numpy(), g.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert float(new_err.abs().max()) <= float(g.abs().max()) / 127.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_matches(dtype):
    """One tensor's quantisation against the reference's (eager), bit for
    bit: the int8 levels, the dequantised gradient and the residual."""
    rng = np.random.default_rng(1)
    g = rng.standard_normal(1000).astype(np.float32)
    e = (rng.standard_normal(1000) * 0.01).astype(np.float32)
    want = jax_optim.compress_decompress(
        jnp.asarray(g, getattr(jnp, dtype)), jnp.asarray(e))
    got = optim.compress_decompress(torch.tensor(g).to(getattr(torch, dtype)),
                                    torch.tensor(e))
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(host(a), host(b))


def _opt_inputs(dtype: str, compress: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    p, g = _tree(SHAPES, rng, 0.5), _tree(SHAPES, rng)
    state = {"m": _tree(SHAPES, rng, 0.1),
             "v": optim.tree_map(np.abs, _tree(SHAPES, rng, 0.1)),
             "step": np.int32(3)}
    if compress:
        state["err"] = _tree(SHAPES, rng, 0.01)
    return p, g, state


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches(dtype, compress):
    """One AdamW step of the reference (jitted, as its train step is) and
    the port from identical parameters, gradients and state at step 3,
    with ``compress_grads`` off and on."""
    p, g, state = _opt_inputs(dtype, compress)
    kw = dict(lr=1e-2, warmup_steps=5, compress_grads=compress)
    jcfg, tcfg = jax_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, jg = (jax.tree.map(lambda a: jnp.asarray(a, jdt), t) for t in (p, g))
    jstate = jax.tree.map(jnp.asarray, state)
    want_p, want_s, want_m = jax.jit(
        lambda a, b, c: jax_optim.apply(jcfg, a, b, c))(jp, jstate, jg)
    tp, tg = (optim.tree_map(lambda a: torch.tensor(a).to(tdt), t)
              for t in (p, g))
    got_p, got_s, got_m = optim.apply(
        tcfg, tp, optim.state_from_numpy(state, tcfg, tp, device=CPU), tg)

    assert int(got_s["step"]) == int(want_s["step"]) == 4
    assert float(got_m["lr"]) == float(want_m["lr"])
    assert optim.tree_map(lambda t: t.dtype, got_p) == optim.tree_map(
        lambda t: tdt, tp)
    tol = BF16_COMPRESS_TOL if dtype == "bfloat16" and compress else OPT_TOL
    # bf16 parameters: equal, or one bf16 step apart where the float32
    # update the moments give lands across a rounding boundary
    _close(got_p, want_p, {("bfloat16", False): 0.0,
                           ("bfloat16", True): 2.0 ** -8}.get(
                               (dtype, compress), OPT_TOL), "params")
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=tol)
    for k in ("m", "v"):
        _close(got_s[k], want_s[k], tol, k)
    if compress:
        gmax = max(float(np.abs(x).max()) for x in paths(g).values())
        for k, a in paths(got_s["err"]).items():
            b = host(paths(want_s["err"])[k])
            assert float(np.abs(host(a) - b).max()) <= OPT_TOL * gmax, k


def test_weight_decay_follows_ndim_p20():
    """P20: decay applies where ``p.ndim >= 2``.  With zero gradients and
    zero moments the update is the decay alone: the stacked per-layer
    norm scale (L, d) and the matrices shrink by ``lr * wd * p``; the final
    norm ``ln_f`` (d,) does not move.  The same in both packages."""
    rng = np.random.default_rng(2)
    p = _tree(SHAPES, rng)
    zero = optim.tree_map(np.zeros_like, p)
    kw = dict(lr=0.5, warmup_steps=1, weight_decay=0.1)
    tcfg = optim.AdamWConfig(**kw)
    tp = optim.tree_map(torch.tensor, p)
    got, _, _ = optim.apply(tcfg, tp, optim.init(tcfg, tp, device=CPU),
                            optim.tree_map(torch.tensor, zero))
    want, _, _ = jax_optim.apply(
        jax_optim.AdamWConfig(**kw), jax.tree.map(jnp.asarray, p),
        jax_optim.init(jax_optim.AdamWConfig(**kw),
                       jax.tree.map(jnp.asarray, p)),
        jax.tree.map(jnp.asarray, zero))
    np.testing.assert_array_equal(got["ln_f"].numpy(), p["ln_f"])
    for k in ("embed",):
        np.testing.assert_allclose(got[k].numpy(), p[k] * (1 - 0.05),
                                   rtol=1e-6)
    np.testing.assert_allclose(got["layers"]["ln1"].numpy(),
                               p["layers"]["ln1"] * (1 - 0.05), rtol=1e-6)
    _close(got, want, OPT_TOL, "params")


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16"},
                                {"compress_grads": True}])
def test_init_and_state_specs(kw):
    """``init``: the reference's state tree, shapes and dtypes (bf16 moments
    where ``moment_dtype`` says so, ``err`` where compressing, an int32
    step of 0); ``state_specs`` mirrors the parameter specs with the step
    replicated: ``P()``, the entries of the reference's."""
    p = _tree(SHAPES, np.random.default_rng(3))
    want = jax_optim.init(jax_optim.AdamWConfig(**kw),
                          jax.tree.map(jnp.asarray, p))
    got = optim.init(optim.AdamWConfig(**kw),
                     optim.tree_map(torch.tensor, p), device=CPU)
    assert set(got) == set(want)
    for k, a in paths(got).items():
        b = paths(want)[k]
        assert tuple(a.shape) == b.shape and \
            str(a.dtype).removeprefix("torch.") == str(b.dtype), k
        assert not a.any()
    specs = optim.state_specs({"w": "spec"}, optim.AdamWConfig(**kw))
    assert specs == {"m": {"w": "spec"}, "v": {"w": "spec"},
                     "step": ctx.P(),
                     **({"err": {"w": "spec"}} if kw.get("compress_grads")
                        else {})}
    ref = jax_optim.state_specs({"w": "spec"}, jax_optim.AdamWConfig(**kw))
    assert isinstance(specs["step"], ctx.PartitionSpec)
    assert tuple(specs["step"]) == tuple(ref["step"]) == ()


def test_state_from_numpy_refuses_other_trees():
    p = optim.tree_map(torch.tensor, _tree(SHAPES, np.random.default_rng(4)))
    cfg = optim.AdamWConfig()
    good = {"m": optim.tree_map(lambda t: t.numpy(), p),
            "v": optim.tree_map(lambda t: t.numpy(), p), "step": 2}
    st = optim.state_from_numpy(good, cfg, p, device=CPU)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 2
    with pytest.raises(ValueError, match="state keys"):
        optim.state_from_numpy({**good, "err": good["m"]}, cfg, p,
                               device=CPU)
    with pytest.raises(ValueError, match="shape"):
        optim.state_from_numpy({**good, "m": {**good["m"], "ln_f": np.zeros(
            3, np.float32)}}, cfg, p, device=CPU)
    with pytest.raises(ValueError, match="params must be on"):
        optim.init(cfg, p, device="meta")


# ---------------------------------------------------------------------------
# the train step from carried-over state


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mixtral_8x7b",
                                  "whisper_large_v3"])
def test_train_steps_match_from_carried_state(arch):
    """The reference trains two steps from its init; its parameters and
    AdamW state cross to the port (``params_from_numpy``,
    ``state_from_numpy``), and both packages take three more steps on the
    same batches: the metrics and every parameter leaf agree."""
    (jcfg, jp), (tcfg, _) = both_params(arch, "float32", seed=4)
    kw = dict(lr=3e-3, warmup_steps=5)
    jopt, topt = jax_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    data = pipeline.TokenPipeline(tcfg, pipeline.DataConfig(global_batch=2,
                                                            seq_len=24))
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))
    jstate = jax_optim.init(jopt, jp)
    for i in range(2):
        jp, jstate, _ = jstep(jp, jstate, jax.tree.map(
            jnp.asarray, data.batch_at(i)))
    tp = lm.params_from_numpy(jax.tree.map(host, jp), tcfg, device=CPU)
    tstate = optim.state_from_numpy(jax.tree.map(host, jstate), topt, tp,
                                    device=CPU)
    tstep = make_train_step(tcfg, topt)
    for i in range(2, 5):
        batch = data.batch_at(i)
        jp, jstate, jm = jstep(jp, jstate, jax.tree.map(jnp.asarray, batch))
        tp, tstate, tm = tstep(tp, tstate, batch, device=CPU)
        assert set(tm) == set(jm)
        for k in ("loss", "nll", "aux", "grad_norm"):
            if k in jm:
                assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                     abs=1e-7), (i, k)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    _close(tp, jp, STEP_TOL, "params")
    _close(tstate["m"], jstate["m"], STEP_TOL, "m")


# ---------------------------------------------------------------------------
# tests/test_train.py on the port


def _setup(arch="qwen3-0.6b", lr=3e-3):
    cfg = configs.get_smoke(arch).scaled(vocab_size=128)
    model = api.build(cfg)
    opt_cfg = optim.AdamWConfig(lr=lr, warmup_steps=5, weight_decay=0.0)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    opt_state = optim.init(opt_cfg, params, device=CPU)
    data = pipeline.TokenPipeline(cfg, pipeline.DataConfig(global_batch=4,
                                                           seq_len=64))
    step = make_train_step(cfg, opt_cfg)
    return cfg, params, opt_state, data, step


def test_loss_decreases_on_markov_data():
    cfg, params, opt_state, data, step = _setup()
    losses = []
    for i in range(30):
        params, opt_state, m = step(params, opt_state, data.batch_at(i),
                                    device=CPU)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_checkpoint_roundtrip_resume(tmp_path):
    """Six steps with a checkpoint at 3; restored, steps 3-5 replay bit for
    bit on the CPU (parameters, state and losses)."""
    cfg, params, opt_state, data, step = _setup()
    for i in range(3):
        params, opt_state, _ = step(params, opt_state, data.batch_at(i),
                                    device=CPU)
    checkpoint.save(tmp_path, 3, {"params": params, "opt": opt_state})
    p1, o1 = params, opt_state
    l1 = []
    for i in range(3, 6):
        p1, o1, m1 = step(p1, o1, data.batch_at(i), device=CPU)
        l1.append(float(m1["loss"]))

    assert checkpoint.latest_step(tmp_path) == 3
    st = checkpoint.restore(tmp_path, 3, {"params": params,
                                          "opt": opt_state})
    p2, o2 = st["params"], st["opt"]
    l2 = []
    for i in range(3, 6):
        p2, o2, m2 = step(p2, o2, data.batch_at(i), device=CPU)
        l2.append(float(m2["loss"]))
    assert l1 == l2
    for a, b in zip(lm.leaves(p1) + lm.leaves(o1), lm.leaves(p2)
                    + lm.leaves(o2)):
        assert torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    cfg, params, *_ = _setup()
    checkpoint.save(tmp_path, 10, {"params": params})
    bad = pathlib.Path(tmp_path) / "step_00000020"
    bad.mkdir()
    (bad / "meta.json").write_text("{}")
    assert checkpoint.latest_step(tmp_path) == 10
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path, 20, {"params": params})


def test_checkpoint_prune(tmp_path):
    for s in (1, 2, 3, 4):
        checkpoint.save(tmp_path, s, {"p": torch.zeros(3)})
    checkpoint.prune(tmp_path, keep=2)
    assert checkpoint.latest_step(tmp_path) == 4
    assert sorted(d.name for d in pathlib.Path(tmp_path).iterdir()) == [
        "step_00000003", "step_00000004"]
    assert checkpoint.restore(tmp_path, 4, {"p": torch.zeros(3)}) is not None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path, 1, {"p": torch.zeros(3)})


def test_checkpoint_layout_and_bf16(tmp_path):
    """bf16, float32, int32 and 0-d leaves survive the round trip bit for
    bit (bf16 stored as uint16, named "bfloat16"); the step directory
    holds the reference's files, ``meta.json`` its keys and the tree's
    structure as ``str(PyTreeDef)`` writes it, and no ``.tmp`` is left."""
    rng = np.random.default_rng(5)
    tree = {"b": torch.tensor(rng.standard_normal((3, 4)),
                              dtype=torch.bfloat16),
            "a": {"y": torch.tensor(rng.standard_normal(5),
                                    dtype=torch.float32),
                  "x": torch.arange(6, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}
    d = checkpoint.save(tmp_path, 5, tree, {"arch": "test"})
    assert sorted(p.name for p in d.iterdir()) == [
        "COMMITTED", "meta.json", "shard_0.npz"]
    assert [p.name for p in pathlib.Path(tmp_path).iterdir()] == [
        "step_00000005"]
    meta = json.loads((d / "meta.json").read_text())
    jtree = {"b": jnp.zeros((3, 4), jnp.bfloat16),
             "a": {"y": jnp.zeros(5), "x": jnp.zeros(6, jnp.int32)},
             "step": jnp.zeros((), jnp.int32)}
    assert meta == {"step": 5, "n_leaves": 4,
                    "treedef": str(jax.tree_util.tree_structure(jtree)),
                    "dtypes": ["int32", "float32", "bfloat16", "int32"],
                    "arch": "test"}
    assert np.load(d / "shard_0.npz")["leaf_2"].dtype == np.uint16
    back = checkpoint.restore(tmp_path, 5, tree)
    for k, a in paths(tree).items():
        b = paths(back)[k]
        assert b.dtype == a.dtype and torch.equal(a, b), k


def _train_state(seed: int):
    """The reference's bf16 smoke parameters and AdamW state after one step
    (non-zero moments), and the port's copy."""
    (jcfg, jp), (tcfg, tp) = both_params("qwen3_0_6b", "bfloat16", seed=seed)
    jopt, topt = jax_optim.AdamWConfig(), optim.AdamWConfig()
    data = jax_pipeline.TokenPipeline(jcfg, jax_pipeline.DataConfig(
        global_batch=2, seq_len=16))
    jp, js, _ = jax.jit(jax_make_train_step(jcfg, jopt))(
        jp, jax_optim.init(jopt, jp), jax.tree.map(jnp.asarray,
                                                   data.batch_at(0)))
    tp = lm.params_from_numpy(jax.tree.map(host, jp), tcfg, device=CPU)
    ts = optim.state_from_numpy(jax.tree.map(host, js), topt, tp, device=CPU)
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _same_leaves(port_tree, ref_tree):
    """Leaves equal bit for bit and in dtype (bf16 compared as its bits)."""
    got, want = paths(port_tree), paths(ref_tree)
    assert set(got) == set(want)
    for k, t in got.items():
        w = np.asarray(want[k])
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), k
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A train state saved by the reference (bf16 parameters, float32
    moments, int32 step) restores in the port, every leaf bit for bit."""
    jtree, ttree = _train_state(seed=6)
    jax_ckpt.save(tmp_path, 7, jtree, {"arch": "qwen3-smoke"})
    assert checkpoint.latest_step(tmp_path) == 7
    _same_leaves(checkpoint.restore(tmp_path, 7, ttree), jtree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A train state saved by the port restores in the reference, every
    leaf bit for bit; both write the same ``meta.json``."""
    jtree, ttree = _train_state(seed=7)
    checkpoint.save(tmp_path / "port", 7, ttree, {"arch": "qwen3-smoke"})
    jax_ckpt.save(tmp_path / "ref", 7, jtree, {"arch": "qwen3-smoke"})
    assert jax_ckpt.latest_step(tmp_path / "port") == 7
    _same_leaves(ttree, jax_ckpt.restore(tmp_path / "port", 7, jtree))
    meta = [json.loads((tmp_path / d / "step_00000007" / "meta.json")
                       .read_text()) for d in ("port", "ref")]
    assert meta[0] == meta[1]


# ---------------------------------------------------------------------------
# launch.train.main


def test_train_main_checkpoints_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the smoke config: six steps with a
    checkpoint every three; with step 6 uncommitted (its ``COMMITTED``
    gone), a second call resumes from step 3, prints so, and ends on the
    first call's parameters and last loss, bit for bit."""
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--log-every", "1"]
    first = train.main(argv, device=CPU)
    assert checkpoint.latest_step(tmp_path) == 6
    (tmp_path / "step_00000006" / "COMMITTED").unlink()
    capsys.readouterr()
    second = train.main(argv, device=CPU)
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert [int(line.split()[1]) for line in out.splitlines()
            if line.startswith("step ")] == [3, 4, 5]
    assert second["last_loss"] == first["last_loss"]
    assert set(first) == {"first_loss", "last_loss", "params"}
    for a, b in zip(lm.leaves(first["params"]), lm.leaves(second["params"])):
        assert torch.equal(a, b)
    assert checkpoint.latest_step(tmp_path) == 6


def test_train_main_refuses_the_production_mesh_here():
    with pytest.raises(ValueError, match="needs 256 devices, 1 available"):
        train.main(["--smoke", "--steps", "1", "--mesh", "production"],
                   device=CPU)


# ---------------------------------------------------------------------------
# meshes


def test_multi_axis_mesh():
    """A mesh of several axes: a grid nested one level per axis, ``shape``
    in axis order, ``dp_axes``/``mesh_sizes`` as on one axis, and the
    planner's shards along the DP axes only (index 0 of ``model``)."""
    a, b = torch.device("cpu"), torch.device("meta")
    m = ctx.Mesh(((a, b), (b, a), (a, a)), ("data", "model"))
    assert m.shape == {"data": 3, "model": 2} == ctx.mesh_sizes(m)
    assert ctx.dp_axes(m) == ("data",) and ctx.planner_axes(m) == ("data",)
    assert ctx.dp_devices(m) == (a, b, a)
    p = ctx.Mesh((((a,), (b,)),), ("pod", "data", "model"))
    assert p.shape == {"pod": 1, "data": 2, "model": 1}
    assert ctx.dp_axes(p) == ("pod", "data") and ctx.dp_devices(p) == (a, b)
    one = ctx.planner_mesh(devices=["cpu"] * 3)
    assert one.devices == (a, a, a) and ctx.dp_devices(one) == one.devices
    with pytest.raises(ValueError, match="ragged"):
        ctx.Mesh(((a, b), (a,)), ("data", "model"))
    with pytest.raises(ValueError, match="deeper"):
        ctx.Mesh(((a,),), ("data",))
    with pytest.raises(ValueError, match="one axis"):
        ctx.Mesh((a, b), ("data", "model"))
    with pytest.raises(ValueError, match="no data-parallel axis"):
        ctx.dp_devices(ctx.Mesh(((a, b),), ("model", "x")))


def test_local_and_production_meshes(monkeypatch):
    """``make_local_mesh``: (1, 1) over ``("data", "model")``, the CPU when
    asked, else the card (``RuntimeError`` without CUDA);
    ``make_production_mesh`` refuses with ``ValueError`` and names the
    256 or 512 devices it needs, as ``jax.make_mesh`` fails here."""
    local = mesh.make_local_mesh("cpu")
    assert local.axis_names == ("data", "model")
    assert local.shape == {"data": 1, "model": 1}
    assert local.devices == ((torch.device("cpu"),),)
    assert mesh.dp_axes(local) == ("data",)
    with ctx.mesh_context(local):
        assert ctx.current_mesh() is local
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_production_mesh()


# ---------------------------------------------------------------------------
# data and cells


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "internvl2_2b",
                                  "whisper_large_v3"])
def test_token_pipeline_matches(arch):
    """``TokenPipeline.batch_at`` bit for bit (tokens, labels, a VLM's prefix
    embeddings, an encoder-decoder's frames), at steps out of order, as a
    resumed job seeks."""
    dc = dict(seed=3, global_batch=3, seq_len=20)
    want = jax_pipeline.TokenPipeline(jax_configs.get_smoke(arch),
                                      jax_pipeline.DataConfig(**dc))
    got = pipeline.TokenPipeline(configs.get_smoke(arch),
                                 pipeline.DataConfig(**dc))
    np.testing.assert_array_equal(got.succ, want.succ)
    for step in (5, 0, 17, 5):
        a, b = got.batch_at(step), want.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_particle_feed_matches():
    want = jax_pipeline.ParticleFeed(24, 16, n_particles=5000, seed=2)
    got = pipeline.ParticleFeed(24, 16, n_particles=5000, seed=2)
    for _ in range(4):
        np.testing.assert_array_equal(got.load_matrix(), want.load_matrix())
        got.step()
        want.step()
    np.testing.assert_array_equal(got.pos, want.pos)


def test_cells_match():
    assert cells.SHAPES == {k: cells.Shape(**vars(v))
                            for k, v in jax_cells.SHAPES.items()}
    assert cells.all_cells() == jax_cells.all_cells()
    assert cells.runnable_cells() == jax_cells.runnable_cells()
    assert [cells.skip_reason(a, s) for a, s in cells.all_cells()] == [
        jax_cells.skip_reason(a, s) for a, s in jax_cells.all_cells()]
