"""The port's cost model (``repro_torch.launch.{op_cost,roofline}``) on the
CPU: its loop-aware count against the whole run, its FLOPs and argument
bytes against the reference's ``hlo_cost`` and ``memory_analysis`` of the
same step compiled on a (1, 1) Auto-axis ``jax.sharding.Mesh`` (F6), and
the spec-derived collectives and output bytes.

Limits:
- the loop-aware count (``cell_costs``) equals ``count`` of the whole
  step exactly (FLOPs, bytes, unread arguments), and ``count``'s FLOPs
  equal ``FlopCounterMode``'s, on every smoke config at its own depth and
  at three periods of its layer pattern;
- prefill and decode FLOPs equal the reference's exactly; train FLOPs lie
  within ``TRAIN_FLOP_GAP`` = 3% of it.  The gap is the programs', not
  the counts' (``PERF.md``, the sharded steps' findings): the reference's
  backward of each visited attention pair computes the scores q.k^T once
  more (5 products a pair, the port's autograd 4); its remat drops the
  MoE's combine product and the encoder-decoder's head product that
  ``torch.utils.checkpoint`` runs again; and a multi-operand einsum's
  gradient is a dot in one program and a broadcast product (not a FLOP)
  in the other (the MoE gate, the SSD scan).  At most 2.78% (Qwen3
  smoke, 8,388,608 FLOPs);
- argument bytes equal the reference's exactly: an argument the step
  never reads is not counted, as ``jax.jit`` prunes it.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jax_configs
from repro.dist import ctx as jax_ctx
from repro.launch import cells as jax_cells
from repro.launch import hlo_cost
from repro.launch import steps as jax_steps
from repro_torch import configs
from repro_torch.dist import ctx
from repro_torch.launch import cells, op_cost, roofline, steps
from repro_torch.models import lm

from _torch_models_parity import paths

TRAIN_FLOP_GAP = 0.03
B, S = 4, 64
KINDS = ("train", "prefill", "decode")
BUILD = {"train": steps.build_train, "prefill": steps.build_prefill,
         "decode": steps.build_decode}
REF_BUILD = {"train": jax_steps.build_train,
             "prefill": jax_steps.build_prefill,
             "decode": jax_steps.build_decode}
ONE = ctx.abstract_mesh((1, 1), ("data", "model"))


def _smoke(arch, periods: int | None = None):
    """The smoke config as overrides, at ``periods`` periods of its layer
    pattern (both stacks of the encoder-decoder) when given."""
    cfg = configs.get_smoke(arch)
    if periods:
        n = periods * (cfg.global_every or 1)
        cfg = cfg.scaled(n_layers=n, encoder_layers=n if cfg.family ==
                         "encdec" else 0)
    return dataclasses.asdict(cfg)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, kind: str) -> tuple:
    """(hlo_cost FLOPs, argument bytes) of the reference's step of the
    smoke config at (B, S), compiled on a (1, 1) Auto-axis mesh."""
    jm = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    ov = dataclasses.asdict(jax_configs.get_smoke(arch))
    with jm, jax_ctx.mesh_context(jm):
        fn, specs = REF_BUILD[kind](arch, jax_cells.Shape("c", kind, S, B),
                                    jm, overrides=ov)
        compiled = fn.lower(*specs).compile()
    return (int(hlo_cost.analyze_text(compiled.as_text()).flops),
            compiled.memory_analysis().argument_size_in_bytes)


@pytest.mark.parametrize("periods", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_loop_aware_count_equals_the_whole_run(arch, kind, periods):
    """``cell_costs`` (attention's loops folded, the stacks extrapolated
    from one and two periods) = ``count`` of the whole step, and
    ``count``'s FLOPs = ``FlopCounterMode``'s."""
    ov = _smoke(arch, periods)
    shape = cells.Shape("c", kind, S, B)
    fn, args = BUILD[kind](arch, shape, ONE, overrides=ov)
    whole = op_cost.count(fn, *args)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert whole.flops == fc.get_total_flops() > 0
    aware = op_cost.cell_costs(arch, shape, overrides=ov)
    assert (aware.flops, aware.bytes, aware.unread) == \
        (whole.flops, whole.bytes, whole.unread)


def test_folding_restores_the_attention():
    """``cell_costs`` puts ``layers.chunked_attention`` back after folding
    it (here on hymba's banded prefill)."""
    from repro_torch.models import layers
    real = layers.chunked_attention
    op_cost.cell_costs("hymba_1_5b", cells.Shape("c", "prefill", 96, 2),
                       overrides=_smoke("hymba_1_5b"))
    assert layers.chunked_attention is real


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_flops_and_argument_bytes_match_the_reference(arch, kind):
    ref_flops, ref_args = _reference(arch, kind)
    shape = cells.Shape("c", kind, S, B)
    fn, args = BUILD[kind](arch, shape, ONE, overrides=_smoke(arch))
    costs = op_cost.cell_costs(arch, shape, overrides=_smoke(arch))
    if kind == "train":
        assert abs(costs.flops - ref_flops) <= TRAIN_FLOP_GAP * ref_flops, \
            (costs.flops, ref_flops)
    else:
        assert costs.flops == ref_flops
    mem = roofline.memory_summary(fn, args, shape, costs.unread)
    assert mem["argument_bytes"] == ref_args


def test_qwen3_smoke_counts():
    """Qwen3's smoke config at B=4, S=64: the counts ``PERF.md`` quotes,
    and the train gap to the reference of one score product a visited
    attention pair (32 pairs of 16 x 16 chunks, 262,144 FLOPs each)."""
    got = {k: op_cost.cell_costs("qwen3_0_6b", cells.Shape("c", k, S, B),
                                 overrides=_smoke("qwen3_0_6b")).flops
           for k in KINDS}
    assert got == {"train": 293_601_280, "prefill": 67_239_936,
                   "decode": 1_179_648}
    assert _reference("qwen3_0_6b", "train")[0] - got["train"] == 8_388_608


def _shard_sum(tree, specs, sizes) -> int:
    specs = paths(specs)
    return sum(roofline.shard_bytes(t, specs[k], sizes)
               for k, t in paths(tree).items())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "whisper_large_v3",
                                  "mamba2_1_3b"])
def test_output_bytes_are_the_outputs_shards(arch, kind):
    """``memory_summary``'s output bytes = the shard bytes of what the step
    returns on meta (train: parameters and state by their specs, float32
    metrics whole; serving: logits batch-sharded, the cache by its
    specs)."""
    m = ctx.abstract_mesh((2, 2), ("data", "model"))
    sizes = ctx.mesh_sizes(m)
    shape = cells.Shape("c", kind, S, B)
    fn, args = BUILD[kind](arch, shape, m, overrides=_smoke(arch))
    out = fn(*args)
    if kind == "train":
        want = (_shard_sum(out[0], fn.out_specs[0], sizes)
                + _shard_sum(out[1], fn.out_specs[1], sizes)
                + sum(v.numel() * v.element_size() for v in out[2].values()))
    else:
        logits, cache = out
        want = (logits.numel() * 4 // 2
                + _shard_sum(cache, fn.out_specs[1], sizes))
    assert roofline.memory_summary(fn, args, shape)["output_bytes"] == want


def test_collectives_from_the_specs():
    """On (1, 1) nothing moves.  On a model-only (1, 4) mesh a decode step
    all-reduces the outputs of its row-parallel products (``wo``, ``w2``:
    B x 1 x d x 2 bytes a layer each).  On a data-only (4, 1) mesh a train
    step all-gathers each FSDP leaf twice and reduce-scatters its
    gradient, and all-reduces the gradient of each leaf left
    replicated."""
    ov = _smoke("qwen3_0_6b")
    cfg = configs.get_smoke("qwen3_0_6b")
    for kind in KINDS:
        sh = cells.Shape("c", kind, S, B)
        fn, args = BUILD[kind]("qwen3_0_6b", sh, ONE, overrides=ov)
        assert set(roofline.collective_bytes(fn, args, sh).values()) == {0}
    sh = cells.Shape("c", "decode", S, B)
    fn, args = steps.build_decode("qwen3_0_6b", sh, ctx.abstract_mesh(
        (1, 4), ("data", "model")), overrides=ov)
    assert roofline.collective_bytes(fn, args, sh) == {
        "all-gather": 0, "reduce-scatter": 0,
        "all-reduce": 2 * cfg.n_layers * B * 1 * cfg.d_model * 2}
    sh = cells.Shape("c", "train", S, B)
    m = ctx.abstract_mesh((4, 1), ("data", "model"))
    fn, (p, o, b) = steps.build_train("qwen3_0_6b", sh, m, overrides=ov)
    gathered = reduced = 0
    for t, sp in zip(lm.leaves(p), lm.leaves(fn.in_specs[0])):
        n = t.numel() * t.element_size()
        if "data" in tuple(sp):
            gathered += n
        else:
            reduced += n
    assert gathered and reduced
    assert roofline.collective_bytes(fn, (p, o, b), sh) == {
        "all-gather": 2 * gathered, "reduce-scatter": gathered // 4,
        "all-reduce": reduced}
    rl = roofline.analyze(op_cost.Costs(8, 12), fn, (p, o, b), sh)
    assert (rl.flops, rl.bytes_accessed) == (2.0, 3.0)
    assert rl.coll_bytes == 2 * gathered + gathered // 4 + reduced
    assert rl.t_collective == rl.coll_bytes / roofline.LINK_BW
    assert rl.dominant == "collective" and rl.bound_time == rl.t_collective
