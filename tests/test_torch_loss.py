"""The port's training objective (``lm.loss_fn``, ``lm.chunked_ce``,
``encdec.loss_fn``, ``api.build(cfg).loss``) and ``api``'s spec functions
against the JAX package, on the CPU.

The same weights (the reference's ``init_params`` with every norm scale
and the SSM's scalars drawn from a seed, ``_torch_models_parity``) and
the same NumPy batches go through both packages at float32 on every
family's smoke config: dense, VLM, the two MoE models (GQA and MLA), the
SSM, the hybrid and the encoder-decoder.

Tolerances:
- the loss and its metrics within ``LOSS_TOL`` = 1e-5 relative (float32
  sums over the batch in another order; measured under 1e-7);
- the gradients of every parameter leaf within ``GRAD_TOL`` = 1e-4 of
  the reference's, as the relative L2 of the difference (measured at
  most 3e-6); a graph broken by a host read or an integer bit trick
  would show here as a leaf whose gradient is missing or zero;
- ``chunked_ce`` alone within 1e-6 relative, gradients included;
- the spec functions' shapes and dtypes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import api as jax_api
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro_torch import configs
from repro_torch.models import api, encdec, lm

from _torch_models_parity import CPU, both_params, host, inputs, paths

FAMILIES = ["qwen3_0_6b", "internvl2_2b", "mixtral_8x7b", "deepseek_v2_236b",
            "mamba2_1_3b", "hymba_1_5b", "whisper_large_v3"]
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
#: 576 tokens: past ``chunked_ce``'s chunk of 512, so the second chunk is
#: padded (448 zero positions of weight 0), and a whole number of the MoE
#: smoke models' dispatch groups of 64 (P15); the attention's blocks are
#: widened to 192 in both packages (the smoke configs' 16 would make
#: 37 x 37 blocks a layer)
S_PAD, PAD_CHUNKS = 576, {"q_chunk": 192, "kv_chunk": 192}


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


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens and next-token labels (B, S) and the family's other input."""
    toks, extra = inputs(cfg, B, S + 1, seed=seed)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = extra
    if cfg.family == "encdec":
        batch["frames"] = extra
    return batch


def _ref_loss(jcfg):
    mod = jax_encdec if jcfg.family == "encdec" else jax_lm
    return lambda p, b: mod.loss_fn(p, jcfg, b)


def _grads(tcfg, tp, batch, remat: bool = True):
    """The port's loss, metrics and gradients by leaf path."""
    req = {k: t.detach().requires_grad_() for k, t in paths(tp).items()}

    def tree(t, path=""):
        if isinstance(t, dict):
            return {k: tree(v, f"{path}/{k}") for k, v in t.items()}
        return req[path]

    mod = encdec if tcfg.family == "encdec" else lm
    loss, metrics = mod.loss_fn(tree(tp), tcfg, batch, remat=remat,
                                device=CPU)
    grads = torch.autograd.grad(loss, list(req.values()), allow_unused=True)
    return loss, metrics, dict(zip(req, grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches(arch):
    """``build(cfg).loss`` on a batch of 2 x 576 tokens (``chunked_ce`` pads
    the second chunk): the loss, ``nll`` and, where the model has one,
    ``aux`` (the MoE's balancing loss, 0 for the others; the loss adds
    0.01 x aux for a model with experts); a VLM's loss covers its text
    positions only."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, "float32", seed=2,
                                         **PAD_CHUNKS)
    batch = _batch(jcfg, 2, S_PAD, seed=4)
    ref_loss, ref_m = _ref_loss(jcfg)(jp, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    with torch.no_grad():
        loss, metrics = api.build(tcfg).loss(tp, batch, device=CPU)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert set(metrics) == set(ref_m)
    for k, v in {"loss": (loss, ref_loss), **{
            k: (metrics[k], ref_m[k]) for k in ref_m}}.items():
        got, want = float(v[0]), float(v[1])
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1.0), \
            (k, got, want)
    if tcfg.n_experts:
        assert float(metrics["aux"]) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match(arch):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` against the
    port's autograd through the checkpointed layers and chunks: every
    leaf's gradient within ``GRAD_TOL`` (relative L2), none missing."""
    (jcfg, jp), (tcfg, tp) = both_params(arch, "float32", seed=3)
    batch = _batch(jcfg, 2, 21, seed=5)
    (ref_loss, _), ref_g = jax.value_and_grad(_ref_loss(jcfg), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = _grads(tcfg, tp, batch)
    assert float(loss.detach()) == pytest.approx(float(ref_loss),
                                                 rel=LOSS_TOL)
    ref_g = paths(ref_g)
    assert set(grads) == set(ref_g)
    for k, g in grads.items():
        want = host(ref_g[k])
        assert g is not None, f"{k}: no gradient"
        scale = float(np.linalg.norm(want))
        assert scale > 0, f"{k}: the reference's gradient is zero"
        rel = float(np.linalg.norm(g.numpy() - want)) / scale
        assert rel <= GRAD_TOL, f"{k}: relative L2 {rel:.3g}"


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mixtral_8x7b",
                                  "whisper_large_v3"])
def test_remat_changes_nothing(arch):
    """Checkpointing each layer (``remat=True``, the default) gives the
    loss and the gradients of the run without it, bit for bit: the
    backward pass recomputes the same activations."""
    _, (tcfg, tp) = both_params(arch, "float32", seed=1)
    batch = _batch(tcfg, 2, 19, seed=6)
    l1, m1, g1 = _grads(tcfg, tp, batch, remat=True)
    l0, m0, g0 = _grads(tcfg, tp, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m0[k]))
               for k in m0)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k


@pytest.mark.parametrize("S,chunk", [(21, 8), (16, 8), (5, 512)])
def test_chunked_ce_matches(S, chunk):
    """``chunked_ce`` alone, on a float32 head and weights with zeros (S not
    a multiple of the chunk pads x, the labels and the weights): the loss
    and its gradients with respect to x and the head's weight within
    1e-6, against the reference's own ``chunked_ce`` at the same chunk."""
    rng = np.random.default_rng(S + chunk)
    B, d, V = 3, 16, 40
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w_head = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    weights = (rng.random((B, S)) * (rng.random((B, S)) > 0.3)).astype(
        np.float32)

    def ref(x, w):
        return jax_lm.chunked_ce(lambda xc: xc @ w, x, jnp.asarray(labels),
                                 jnp.asarray(weights), chunk=chunk)

    ref_l, (ref_gx, ref_gw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w_head))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w_head, requires_grad=True)
    loss = lm.chunked_ce(lambda xc: xc @ tw, tx, torch.tensor(labels),
                         torch.tensor(weights), chunk=chunk)
    gx, gw = torch.autograd.grad(loss, [tx, tw])
    assert float(loss) == pytest.approx(float(ref_l), rel=1e-6)
    for got, want in ((gx, ref_gx), (gw, ref_gw)):
        want = host(want)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(
            np.abs(want).max())


def test_chunked_ce_all_weights_zero():
    """A batch of weight 0 gives a loss of 0 (the mean divides by max(sum
    of weights, 1)), as the reference's."""
    x = torch.ones(1, 3, 4)
    loss = lm.chunked_ce(lambda xc: xc @ torch.ones(4, 5),
                         x, torch.zeros(1, 3, dtype=torch.int32),
                         torch.zeros(1, 3))
    assert float(loss) == 0.0 == float(jax_lm.chunked_ce(
        lambda xc: xc @ jnp.ones((4, 5)), jnp.ones((1, 3, 4)),
        jnp.zeros((1, 3), jnp.int32), jnp.zeros((1, 3))))


def _shapes(tree):
    """{path: (shape, dtype name)} of a tree of tensors or of
    ``ShapeDtypeStruct``s (tuples of them included)."""
    if isinstance(tree, dict):
        return {f"/{k}{p}": v for k in sorted(tree)
                for p, v in _shapes(tree[k]).items()}
    if isinstance(tree, tuple):
        return {f"/{i}{p}": v for i, t in enumerate(tree)
                for p, v in _shapes(t).items()}
    dt = tree.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
    return {"": (tuple(int(d) for d in tree.shape), name)}


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_specs_match(arch):
    """``train_batch_spec``, ``prefill_batch_spec``, ``decode_inputs_spec``,
    ``cache_spec`` and ``param_spec`` for the full config: the reference's
    ``ShapeDtypeStruct`` shapes and dtypes, as tensors on the ``meta``
    device (nothing allocated), and ``count_params`` their sum."""
    jcfg, tcfg = jax_configs.get(arch), configs.get(arch)
    B, S = 4, 4096
    for name, args in (("train_batch_spec", (B, S)),
                       ("prefill_batch_spec", (B, S)),
                       ("decode_inputs_spec", (B,)),
                       ("cache_spec", (B, S)),
                       ("param_spec", ())):
        want = _shapes(getattr(jax_api, name)(jcfg, *args))
        got = _shapes(getattr(api, name)(tcfg, *args))
        assert got == want, name
    assert api.count_params(tcfg) == jax_api.count_params(jcfg)
