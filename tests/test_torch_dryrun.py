"""The port's sharded steps and dry run (``repro_torch.launch.{steps,
dryrun,roofline}``) against its own unmeshed path and the JAX package, on
the CPU.

- ``build_train``/``build_prefill``/``build_decode`` on the local mesh
  (``make_local_mesh("cpu")``) and on a (2, 2) ``("data", "model")`` mesh
  that names the CPU four times give values ``torch.equal`` to the
  unmeshed step (``make_train_step``, ``models.api``): the specs are hints
  that change no value.  On the (2, 2) mesh the chunked attention takes
  its head-sharded branch where the heads divide.
- The same steps against the reference's ``build_*``, jitted on a (1, 1)
  ``jax.sharding.Mesh`` with Auto axes (``launch/mesh.py``'s
  ``jax.make_mesh`` gives Explicit axes under jax 0.9.0, where the
  reference's ``constrain`` raises: F6 in ``ROADMAP.md``), at float32,
  within the model and train tests' tolerances: logits and caches 1e-4 x
  max |reference|, the loss and ``grad_norm`` 1e-5 relative, parameters
  and moments 1e-4 x max |reference| (``STEP_TOL``).
- The record's keys and skip reasons are the reference's; the command
  line writes one record per (cell, mesh).
"""
import ast
import dataclasses
import functools
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import repro.configs as jax_configs
from repro.dist import ctx as jax_ctx
from repro.launch import cells as jax_cells
from repro.launch import hlo_analysis
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.train import optim as jax_optim
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.dist import ctx
from repro_torch.launch import cells, dryrun, mesh, steps
from repro_torch.models import api, lm
from repro_torch.train import optim

from _torch_models_parity import (CPU, F32, assert_cache, assert_close,
                                  both_params, host, paths)

STEP_TOL = 1e-4
ARCHS = ["qwen3_0_6b", "deepseek_v2_236b", "mamba2_1_3b", "whisper_large_v3"]
B, S, CTX = 4, 48, 64
OPT = dict(lr=3e-3, warmup_steps=5)
REF_DRYRUN = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
              / "launch" / "dryrun.py")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes():
    return {"local": mesh.make_local_mesh("cpu"),
            "2x2": ctx.Mesh((("cpu", "cpu"), ("cpu", "cpu")),
                            ("data", "model"))}


def _ov(cfg) -> dict:
    """Every field of ``cfg``: the builders take the full config and apply
    overrides, so a smoke config reaches them as overrides."""
    return dataclasses.asdict(cfg)


def _batch(cfg, kind: str, seed: int = 0):
    data = pipeline.TokenPipeline(cfg, pipeline.DataConfig(global_batch=B,
                                                           seq_len=S))
    batch = data.batch_at(seed)
    if kind == "prefill":
        batch.pop("labels")
    return batch


def _equal(a, b, what):
    pa, pb = paths(a), paths(b)
    assert set(pa) == set(pb), what
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]), \
            (what, k)


def _ref_batch(batch):
    """A batch as the reference's compiled steps take it: float entries
    (an encoder-decoder's frames) in bf16, as its input specs say."""
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else v.dtype) for k, v in batch.items()}


def _port_batch(batch):
    """The same batch for the port: the float entries rounded to bf16."""
    return {k: torch.tensor(v).to(torch.bfloat16 if v.dtype == np.float32
                                  else torch.int32)
            for k, v in batch.items()}


def _extra(cfg, rng):
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)}
    return {}


# ---------------------------------------------------------------------------
# build_* against the port's unmeshed path


@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_matches_unmeshed(arch):
    """Two steps of ``build_train`` on each mesh = ``make_train_step``
    without a mesh, from the same start, bit for bit."""
    cfg = configs.get_smoke(arch).scaled(dtype="float32")
    oc = optim.AdamWConfig(**OPT)
    p0 = api.build(cfg).init(torch.Generator().manual_seed(1), device=CPU)
    want = (p0, optim.init(oc, p0, device=CPU))
    step = steps.make_train_step(cfg, oc)
    for i in range(2):
        *want, wm = step(*want, _batch(cfg, "train", i), device=CPU)
    for name, m in _meshes().items():
        fn, specs = steps.build_train(arch, cells.Shape("t", "train", S, B),
                                      m, opt_cfg=oc, overrides=_ov(cfg))
        assert fn.device == torch.device("cpu") and fn.mesh is m
        got = (p0, optim.init(oc, p0, device=CPU))
        for i in range(2):
            *got, gm = fn(*got, _batch(cfg, "train", i))
        _equal({"p": got[0], "o": got[1], "m": gm},
               {"p": want[0], "o": want[1], "m": wm}, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serving_matches_unmeshed(arch):
    """``build_prefill`` then two ``build_decode`` steps on each mesh =
    ``models.api`` without a mesh: logits and every cache tensor bit for
    bit."""
    cfg = configs.get_smoke(arch).scaled(dtype="float32")
    model = api.build(cfg)
    tp = model.init(torch.Generator().manual_seed(1), device=CPU)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, CTX)).astype(np.int32)
    extra = _extra(cfg, rng)

    def run(prefill, decode):
        cache = model.init_cache(B, CTX, device=CPU)
        outs = [prefill(tp, {"tokens": torch.tensor(toks[:, :S]),
                             **{k: torch.tensor(v) for k, v in
                                extra.items()}}, cache)[0]]
        for i in range(2):
            outs.append(decode(tp, torch.tensor(toks[:, S + i:S + i + 1]),
                               torch.full((B,), S + i, dtype=torch.int32),
                               cache)[0])
        return outs, cache

    want = run(functools.partial(model.prefill, device=CPU),
               functools.partial(model.decode, device=CPU))
    for name, m in _meshes().items():
        pf, _ = steps.build_prefill(arch, cells.Shape("p", "prefill", CTX,
                                                      B), m,
                                    overrides=_ov(cfg))
        dc, _ = steps.build_decode(arch, cells.Shape("d", "decode", CTX, B),
                                   m, overrides=_ov(cfg))
        got = run(pf, dc)
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b), name
        _equal(got[1], want[1], name)


def test_head_sharded_branch_on_the_2x2_mesh(monkeypatch):
    """On a (2, 2) mesh the chunked attention hints its chunk stacks
    head-sharded where the heads divide (prefill), sequence-sharded at
    decode; on the (1, 1) mesh too (model axis 1)."""
    from repro_torch.models import layers
    seen = []
    real = layers.constrain

    def tap(x, *spec):
        seen.append((ctx.current_mesh().shape["model"], spec))
        return real(x, *spec)

    monkeypatch.setattr(layers, "constrain", tap)
    cfg = configs.get_smoke("qwen3_0_6b")
    assert cfg.n_heads % 2 == cfg.n_kv_heads % 2 == 0
    for shape in ((1, 1), (2, 2)):
        m = ctx.abstract_mesh(shape, ("data", "model"))
        for kind in ("prefill", "decode"):
            build = steps.build_prefill if kind == "prefill" \
                else steps.build_decode
            fn, args = build("qwen3_0_6b", cells.Shape("c", kind, 64, 4), m,
                             overrides=_ov(cfg))
            fn(*args)
    heads = (None, "dp", None, "model", None)
    seq = (None, "dp", "model", None, None)
    assert (2, heads) in seen and (1, heads) in seen
    assert (2, seq) in seen and (1, seq) in seen


def test_distinct_devices_are_not_ported():
    """A mesh of two distinct devices: ``NotImplementedError``, never a
    fall-back to one device."""
    two = ctx.Mesh((("cpu", "meta"),), ("data", "model"))
    sh = cells.Shape("t", "train", 16, 2)
    ov = _ov(configs.get_smoke("qwen3_0_6b"))
    for build in (steps.build_train, steps.build_prefill,
                  steps.build_decode):
        with pytest.raises(NotImplementedError, match="not ported"):
            build("qwen3_0_6b", sh, two, overrides=ov)
    with pytest.raises(NotImplementedError, match="2 distinct devices"):
        steps.build_cell("qwen3_0_6b", "decode_32k", two)


def test_step_checks_its_inputs_divide():
    """The step refuses an input leaf its spec does not divide, and an
    input tree whose keys are not its specs'."""
    m = _meshes()["2x2"]
    cfg = configs.get_smoke("qwen3_0_6b")
    fn, (p, b, c) = steps.build_prefill("qwen3_0_6b", cells.Shape(
        "p", "prefill", 16, 4), m, overrides=_ov(cfg))
    params = api.build(cfg).init(torch.Generator().manual_seed(0),
                                 device=CPU)
    cache = api.build(cfg).init_cache(4, 16, device=CPU)
    with pytest.raises(ValueError, match="does not divide"):
        fn(params, {"tokens": torch.zeros((3, 16), dtype=torch.int32)},
           cache)
    with pytest.raises(ValueError, match="do not match"):
        fn(params, {"toks": torch.zeros((4, 16), dtype=torch.int32)}, cache)
    with pytest.raises(ValueError, match="takes 3 arguments"):
        fn(params, cache)


def test_abstract_mesh_steps_run_on_meta():
    """On an ``AbstractMesh`` the builders' steps run on ``meta``: the
    outputs have the shapes and dtypes of a real run, and nothing is
    allocated."""
    am = dryrun.production_mesh(False)
    one = {"n_layers": 1}
    fn, (p, t, pos, c) = steps.build_cell("qwen3_0_6b", "decode_32k", am,
                                          overrides=one)
    assert fn.device == torch.device("meta")
    logits, cache = fn(p, t, pos, c)
    assert logits.is_meta and logits.shape == (
        128, 1, configs.get("qwen3_0_6b").padded_vocab)
    assert logits.dtype == torch.float32 and cache is c
    fn, (p, o, b) = steps.build_cell("qwen3_0_6b", "train_4k", am,
                                     overrides=one)
    newp, newo, m = fn(p, o, b)
    for a, c in zip(lm.leaves(newp), lm.leaves(p)):
        assert a.is_meta and a.shape == c.shape and a.dtype == c.dtype
    assert set(m) == {"nll", "aux", "grad_norm", "lr", "loss"}
    assert newo["step"].dtype == torch.int32


def test_builders_pick_bf16_moments_above_1e11_parameters():
    """As the reference: bf16 moments for DeepSeek-V2-236B (above 1e11
    parameters), float32 for Mixtral-8x7B."""
    am = ctx.abstract_mesh((1, 1), ("data", "model"))
    for arch, want in (("deepseek_v2_236b", torch.bfloat16),
                       ("mixtral_8x7b", torch.float32)):
        _, (_, o, _) = steps.build_train(arch, cells.SHAPES["train_4k"], am)
        assert o["m"]["embed"].dtype == o["v"]["embed"].dtype == want
        assert steps.opt_config(configs.get(arch)).moment_dtype == \
            str(want).removeprefix("torch.")


# ---------------------------------------------------------------------------
# build_* against the reference's


def _ref_mesh():
    """(1, 1) over ``("data", "model")`` with Auto axes (F6)."""
    return JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _ref_built(build, arch, shape, cfg, **kw):
    jm = _ref_mesh()
    with jm, jax_ctx.mesh_context(jm):
        fn, specs = build(arch, shape, jm, overrides=_ov(cfg), **kw)
        return fn.lower(*specs).compile()


@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_matches_reference(arch):
    """Two steps of both packages' ``build_train`` from the same float32
    parameters and the same batches."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, "float32", seed=3)
    jf = _ref_built(jax_steps.build_train, arch,
                    jax_cells.Shape("t", "train", S, B), jcfg,
                    opt_cfg=jax_optim.AdamWConfig(**OPT))
    oc = optim.AdamWConfig(**OPT)
    tf, _ = steps.build_train(arch, cells.Shape("t", "train", S, B),
                              _meshes()["local"], opt_cfg=oc,
                              overrides=_ov(tcfg))
    jstate = jax_optim.init(jax_optim.AdamWConfig(**OPT), jp)
    tstate = optim.init(oc, tp, device=CPU)
    for i in range(2):
        batch = _batch(tcfg, "train", i)
        jp, jstate, jm = jf(jp, jstate, _ref_batch(batch))
        tp, tstate, tm = tf(tp, tstate, _port_batch(batch))
        assert set(tm) == set(jm)
        for k in ("loss", "nll", "aux", "grad_norm"):
            if k in jm:
                assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                     abs=1e-7), (i, k)
        assert float(tm["lr"]) == float(jm["lr"])
    for what, got, want in (("params", tp, jp), ("m", tstate["m"],
                                                  jstate["m"])):
        g, w = paths(got), paths(jax.tree.map(host, want))
        assert set(g) == set(w)
        for k in g:
            assert_close(g[k], w[k], STEP_TOL, f"{what}{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serving_matches_reference(arch):
    """Both packages' ``build_prefill`` on a prompt of ``S`` tokens, then
    two ``build_decode`` steps on a cache of ``CTX`` slots that holds it:
    logits and caches within ``F32`` x max |reference|."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, "float32", seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (B, CTX)).astype(np.int32)
    extra = _extra(tcfg, rng)
    jpf = _ref_built(jax_steps.build_prefill, arch,
                     jax_cells.Shape("p", "prefill", S, B), jcfg)
    tpf, _ = steps.build_prefill(arch, cells.Shape("p", "prefill", S, B),
                                 _meshes()["local"], overrides=_ov(tcfg))
    batch = {"tokens": toks[:, :S], **extra}
    jl, jc = jpf(jp, _ref_batch(batch), jax_api.build(jcfg).init_cache(B, S))
    tl, tc = tpf(tp, _port_batch(batch),
                 api.build(tcfg).init_cache(B, S, device=CPU))
    assert_close(tl, jl, F32, "prefill logits")
    assert_cache(tc, jc, F32)

    jdc = _ref_built(jax_steps.build_decode, arch,
                     jax_cells.Shape("d", "decode", CTX, B), jcfg)
    tdc, _ = steps.build_decode(arch, cells.Shape("d", "decode", CTX, B),
                                _meshes()["local"], overrides=_ov(tcfg))
    jc = jax_api.build(jcfg).init_cache(B, CTX)
    _, jc = jax_api.build(jcfg).prefill(jp, _ref_batch(batch), jc)
    tc = api.build(tcfg).init_cache(B, CTX, device=CPU)
    api.build(tcfg).prefill(tp, _port_batch(batch), tc, device=CPU)
    for i in range(2):
        t = toks[:, S + i:S + i + 1]
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jdc(jp, jnp.asarray(t), jnp.asarray(pos), jc)
        tl, tc = tdc(tp, torch.tensor(t), torch.tensor(pos), tc)
        assert_close(tl, jl, F32, f"decode {i}")
        assert_cache(tc, jc, F32)


# ---------------------------------------------------------------------------
# the dry run's records and command line


def _ref_record_keys() -> dict:
    """The keys the reference's ``run_cell`` writes, from its source: the
    record it starts, then each ``rec.update(status=...)``'s keywords."""
    tree = ast.parse(REF_DRYRUN.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    start = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Dict))
    base = [k.value for k in start.keys]
    out = {}
    for n in ast.walk(fn):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "update"):
            kw = {k.arg: k.value for k in n.keywords}
            out[kw["status"].value] = base + list(kw)
    return out


def test_records_keep_the_reference_keys():
    """An ``ok`` record has the reference's keys (``xla_cost`` None), its
    roofline the reference's ``Roofline.as_dict`` keys and ``coll_source``,
    its memory the reference's ``memory_summary`` keys and a ``note``; a
    skipped record the reference's keys and reason."""
    keys = _ref_record_keys()
    ok = dryrun.run_cell("mamba2-1.3b", "decode_32k", multi_pod=True)
    assert list(ok) == keys["ok"] and ok["status"] == "ok"
    assert (ok["mesh"], ok["chips"]) == ("2x16x16", 512)
    assert ok["xla_cost"] is None
    ref_rl = hlo_analysis.Roofline(1.0, 1.0, 1.0, {}).as_dict()
    assert list(ok["roofline"]) == [*list(ref_rl)[:4], "coll_source",
                                    *list(ref_rl)[4:]]
    assert ok["roofline"]["coll_source"] == "specs"
    stub = types.SimpleNamespace(memory_analysis=lambda: types.
                                 SimpleNamespace(argument_size_in_bytes=1,
                                                 output_size_in_bytes=1,
                                                 temp_size_in_bytes=1,
                                                 peak_memory_in_bytes=1))
    assert list(ok["memory"]) == [*hlo_analysis.memory_summary(stub),
                                  "note"]
    assert ok["memory"]["temp_bytes"] is None
    sk = dryrun.run_cell("qwen3-0.6b", "long_500k", multi_pod=False)
    assert list(sk) == keys["skipped"]
    assert sk["reason"] == jax_cells.skip_reason("qwen3-0.6b", "long_500k")
    for a, s in cells.all_cells():
        assert cells.skip_reason(a, s) == jax_cells.skip_reason(a, s)
    tagged = dryrun.run_cell("mamba2-1.3b", "decode_32k", multi_pod=False,
                             overrides={"ssm_chunk": 64}, tag="t1")
    assert (tagged["overrides"], tagged["tag"]) == ({"ssm_chunk": 64}, "t1")


def test_cli_writes_one_record_per_cell_and_mesh(tmp_path, capsys):
    out = tmp_path / "r" / "dryrun.jsonl"
    dryrun.main(["--arch", "qwen3-0.6b", "--multipod", "both", "--out",
                 str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["shape"], r["mesh"]) for r in recs] == [
        (s, m) for s in cells.SHAPES for m in ("16x16", "2x16x16")]
    assert [r["status"] for r in recs].count("skipped") == 2
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 8 and "long_500k" in printed[-1]
    dryrun.main(["--arch", "mamba2_1_3b", "--shape", "long_500k",
                 "--override", "ssm_chunk=64", "--override", "norm_eps=1e-5",
                 "--tag", "it1", "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 9
    assert recs[-1]["overrides"] == {"ssm_chunk": 64, "norm_eps": 1e-5}
    assert recs[-1]["tag"] == "it1" and recs[-1]["status"] == "ok"


def test_cli_all_cells_both_meshes(tmp_path):
    """``--all --multipod both``: 80 records, 66 ok and 14 skipped (the 7
    full-attention ``long_500k`` cells on each mesh); every ok record's
    per-device terms and bytes are positive and the 512-chip mesh holds
    at most the 256-chip mesh's arguments a device."""
    out = tmp_path / "dryrun.jsonl"
    dryrun.main(["--all", "--multipod", "both", "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 80
    assert sum(r["status"] == "ok" for r in recs) == 66
    assert sum(r["status"] == "skipped" for r in recs) == 14
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    for (a, s, m), r in by.items():
        if r["status"] != "ok":
            continue
        rl = r["roofline"]
        assert rl["flops"] > 0 and rl["bytes"] > 0
        assert rl["dominant"] in ("compute", "memory", "collective")
        if m == "2x16x16":
            one = by[(a, s, "16x16")]
            assert r["memory"]["argument_bytes"] <= \
                one["memory"]["argument_bytes"]
            assert rl["flops"] * 2 == one["roofline"]["flops"]
