"""The port's mixture of experts and multi-head latent attention against
the JAX package, on the CPU.

The same NumPy inputs and the reference's own parameters (its
``init_moe`` and ``init_mla``, norm scales set non-zero) go through both
packages, on the mixtral and deepseek smoke configs; the whole models are
held in ``test_torch_models.py``.  The routing (expert ids, capacity
slots, dropped choices) is read from both sides: the reference's through
taps on its own ``jax.lax.top_k`` and ``jax.nn.one_hot`` calls.

Tolerances:

- float32: ``F32`` = 1e-4 x max |reference| on outputs and caches (the
  measured differences are about 3e-7 x: float32 sums in another order);
  ``aux`` within 1e-6 x the reference's; routing ids and slots equal.
- bfloat16: ``moe_forward`` bit for bit (each product is rounded to bf16
  as in the reference, the one-hot dispatch and combine are exact, and
  the experts' matmuls accumulate alike on the CPU), routing equal;
  ``mla_forward`` within ``BF16`` = 4e-2 x max |reference| (its norms
  round their float32 sums differently, see ``test_torch_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import layers as jax_layers
from repro_torch import configs
from repro_torch.models import layers

from _torch_models_parity import BF16, F32, Routings, assert_close, host

ARCHS = ["mixtral_8x7b", "deepseek_v2_236b"]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_port(tree):
    """A reference parameter tree as tensors of the same dtypes."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return torch.from_numpy(host(tree)).to(TORCH[str(tree.dtype)])


def moe_case(arch: str, dtype: str, seed: int = 0, **kw):
    """(reference config, params), (port config, params) of one MoE block
    from the reference's ``init_moe``."""
    jcfg = jax_configs.get_smoke(arch).scaled(dtype=dtype, **kw)
    tcfg = configs.get_smoke(arch).scaled(dtype=dtype, **kw)
    jp = jax_layers.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return (jcfg, jp), (tcfg, to_port(jp))


def activations(shape, dtype: str, seed: int = 0):
    """The same activations for both packages, rounded to ``dtype``."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    jnp.dtype(dtype))
    return x, torch.from_numpy(host(x)).to(TORCH[dtype])


#: (B, S, config changes) of each ``moe_forward`` case
MOE_CASES = {
    "one group": (2, 24, {}),                  # B*S = 48 < moe_group 64
    "two groups": (4, 32, {}),                 # 128 = 2 x 64
    "decode": (3, 1, {}),                      # g = B, C from moe_group
    "drops": (2, 24, {"capacity_factor": 0.25}),   # C = 8 for ~12-24
    "bf16 combine": (4, 32, {"moe_combine_dtype": "bfloat16"}),
    "shared toggled": (2, 24, "shared"),       # deepseek 1 -> 0, mixtral 2
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches(arch, dtype, case, monkeypatch):
    """Outputs, ``aux``, routing ids, capacity slots and the dropped count
    of one MoE block."""
    B, S, kw = MOE_CASES[case]
    if kw == "shared":
        kw = {"n_shared_experts": 0 if arch == "deepseek_v2_236b" else 2}
    (jcfg, jp), (tcfg, tp) = moe_case(arch, dtype, **kw)
    assert ("shared" in tp) == bool(tcfg.n_shared_experts)
    assert tp["router"].dtype == torch.float32
    routes = Routings().install(monkeypatch)
    xj, xt = activations((B, S, jcfg.d_model), dtype)
    ref, raux = jax_layers.moe_forward(jp, jcfg, xj)
    got, aux = layers.moe_forward(tp, tcfg, xt)
    assert got.dtype == TORCH[dtype] and aux.dtype == torch.float32
    jax.effects_barrier()
    ((probs, ids, slots),), (r,) = routes.ref, routes.port
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.slots.numpy(), slots)
    assert r.capacity == jax_layers.moe_capacity(jcfg)
    assert r.dropped == int((slots >= r.capacity).sum())
    if case == "drops":
        assert r.dropped > 0
    else:
        assert r.dropped == 0
    assert abs(float(aux) - float(raux)) <= 1e-6 * float(raux)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(host(got), host(ref))
    else:
        assert_close(got, ref, F32, case)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_matches(arch):
    """C comes from ``moe_group``, not from the group a call has."""
    for kw in ({}, {"capacity_factor": 0.25}, {"capacity_factor": 3.3},
               {"moe_group": 512}, {"moe_group": 7}):
        assert layers.moe_capacity(configs.get_smoke(arch).scaled(**kw)) \
            == jax_layers.moe_capacity(jax_configs.get_smoke(arch).scaled(
                **kw))
    for full in ARCHS:
        assert layers.moe_capacity(configs.get(full)) == \
            jax_layers.moe_capacity(jax_configs.get(full))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_refuses_what_the_reference_asserts_on(arch):
    """Where ``moe_group`` neither exceeds nor divides B*S the reference
    asserts and the port raises ``ValueError``; ``moe_padded_len`` gives
    the smallest length both take (P15)."""
    (jcfg, jp), (tcfg, tp) = moe_case(arch, "float32")
    B, S = 2, 40                        # 80 tokens, moe_group 64
    xj, xt = activations((B, S, jcfg.d_model), "float32")
    with pytest.raises(AssertionError, match="moe_group"):
        jax_layers.moe_forward(jp, jcfg, xj)
    with pytest.raises(ValueError, match="moe_group 64 must divide tokens "
                                         "80"):
        layers.moe_forward(tp, tcfg, xt)
    n = layers.moe_padded_len(tcfg, B, S)
    assert n == 64                      # 128 = 2 x 64
    for m in range(S, n + 1):
        xj, xt = activations((B, m, jcfg.d_model), "float32")
        takes = B * m <= tcfg.moe_group or B * m % tcfg.moe_group == 0
        assert takes == (m == n)
    ref, _ = jax_layers.moe_forward(jp, jcfg, xj)
    assert_close(layers.moe_forward(tp, tcfg, xt)[0], ref, F32, "padded")
    assert layers.moe_padded_len(tcfg, 2, 24) == 24     # 48 <= 64
    assert layers.moe_padded_len(configs.get_smoke("qwen3_0_6b"), 2,
                                 40) == 40              # no experts


def test_top_k_breaks_ties_as_jax():
    """Exact ties, many of them: the same values and indices as
    ``jax.lax.top_k`` (descending, ties to the lower index), where
    ``torch.topk`` promises no order."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (64, 33, 160)).astype(np.float32) / 4
    for k in (1, 2, 6, 160):
        vals, ids = layers.top_k(torch.from_numpy(probs), k)
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_ties_match_the_reference(arch, monkeypatch):
    """A router whose expert columns repeat gives exactly tied
    probabilities: the experts chosen and their slots equal the
    reference's."""
    (jcfg, jp), (tcfg, tp) = moe_case(arch, "float32")
    E = jcfg.n_experts
    router = np.array(jp["router"])
    router[:, E // 2:] = router[:, :E - E // 2]       # expert e+E/2 = e
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router.copy())}
    routes = Routings().install(monkeypatch)
    xj, xt = activations((2, 24, jcfg.d_model), "float32")
    ref, _ = jax_layers.moe_forward(jp, jcfg, xj)
    got, _ = layers.moe_forward(tp, tcfg, xt)
    jax.effects_barrier()
    ((probs, ids, slots),), (r,) = routes.ref, routes.port
    assert (probs[..., :E // 2] == probs[..., E // 2:E // 2 * 2]).all()
    # top 2 = the largest pair, its lower index first
    assert (ids[..., 0] < E // 2).all()
    np.testing.assert_array_equal(ids[..., 1], ids[..., 0] + E // 2)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.slots.numpy(), slots)
    assert_close(got, ref, F32, "tied routing")


# ---------------------------------------------------------------------------
# multi-head latent attention


def mla_case(dtype: str, seed: int = 0):
    """(reference config, params), (port config, params) of deepseek-smoke's
    MLA block from the reference's ``init_mla``, its norm scales set to
    non-zero values."""
    jcfg = jax_configs.get_smoke("deepseek_v2_236b").scaled(dtype=dtype)
    tcfg = configs.get_smoke("deepseek_v2_236b").scaled(dtype=dtype)
    jp = jax_layers.init_mla(jax.random.PRNGKey(seed), jcfg,
                             jnp.dtype(dtype))
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape) * 0.5,
                            jp[k].dtype)
    return (jcfg, jp), (tcfg, to_port(jp))


@pytest.mark.parametrize("mode", ["no cache", "prefill", "prefill ring",
                                  "absorbed decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches(dtype, mode):
    """deepseek-smoke's MLA block with non-zero norm scales: without a
    cache, a prefill into a cache (contiguous, and a ring of 5 slots
    written at pos % 5), and the absorbed decode over a part-filled cache
    (the latent ``c``, the rope key ``kr`` and ``pos`` compared too)."""
    (jcfg, jpa), (tcfg, tpa) = mla_case(dtype)
    tol = F32 if dtype == "float32" else BF16
    B, S, Sc = 2, 11, {"prefill ring": 5}.get(mode, 16)
    xj, xt = activations((B, S, jcfg.d_model), dtype, seed=3)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jc = tc = None
    if mode != "no cache":
        dims = {"c": jcfg.kv_lora_rank, "kr": jcfg.qk_rope_dim}
        jc = {k: jnp.zeros((B, Sc, n), jnp.dtype(dtype))
              for k, n in dims.items()}
        tc = {k: torch.zeros((B, Sc, n), dtype=TORCH[dtype])
              for k, n in dims.items()}
        jc["pos"] = jnp.full((B, Sc), -1, jnp.int32)
        tc["pos"] = torch.full((B, Sc), -1, dtype=torch.int32)
    if mode == "absorbed decode":
        # fill the first 7 slots, then decode at position 7 (row 0) and 9
        _, jc = jax_layers.mla_forward(jpa, jcfg, xj[:, :7],
                                       jnp.asarray(pos[:, :7]),
                                       window=jnp.int32(0), cache=jc)
        layers.mla_forward(tpa, tcfg, xt[:, :7], torch.from_numpy(pos[:, :7]),
                           window=0, cache=tc)
        xj, xt = xj[:, 7:8], xt[:, 7:8]
        pos = np.array([[7], [9]], np.int32)
    absorb = mode == "absorbed decode"
    ref, jnc = jax_layers.mla_forward(jpa, jcfg, xj, jnp.asarray(pos),
                                      window=jnp.int32(0), cache=jc,
                                      absorb=absorb)
    got, tnc = layers.mla_forward(tpa, tcfg, xt, torch.from_numpy(pos),
                                  window=0, cache=tc, absorb=absorb)
    assert got.dtype == TORCH[dtype]
    assert_close(got, ref, tol, mode)
    if mode == "no cache":
        assert tnc is None
        return
    for k in ("c", "kr"):
        assert_close(tnc[k], jnc[k], tol, f"cache {k}")
    np.testing.assert_array_equal(tnc["pos"].numpy(), np.asarray(jnc["pos"]))
    if mode == "prefill ring":                     # positions 6..10 at % 5
        np.testing.assert_array_equal(tnc["pos"][0].numpy(),
                                      [10, 6, 7, 8, 9])


def test_mla_absorbed_decode_equals_the_expanded_path():
    """At float32 the absorbed decode (attention in the latent space) and
    the expanded path give the same step, within 1e-5 x max, and a
    float32 prefill then decode equal ``forward``'s last logits."""
    _, (tcfg, tpa) = mla_case("float32")
    B, S = 2, 12
    _, xt = activations((B, S, tcfg.d_model), "float32", seed=4)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    outs = []
    for absorb in (False, True):
        cache = {"c": torch.zeros((B, 16, tcfg.kv_lora_rank)),
                 "kr": torch.zeros((B, 16, tcfg.qk_rope_dim)),
                 "pos": torch.full((B, 16), -1, dtype=torch.int32)}
        layers.mla_forward(tpa, tcfg, xt[:, :-1], pos[:, :-1], window=0,
                           cache=cache)
        outs.append(layers.mla_forward(tpa, tcfg, xt[:, -1:], pos[:, -1:],
                                       window=0, cache=cache,
                                       absorb=absorb)[0])
    assert_close(outs[1], outs[0], 1e-5, "absorbed vs expanded")
    full, _ = layers.mla_forward(tpa, tcfg, xt, pos, window=0)
    assert_close(outs[1], full[:, -1:], 1e-5, "absorbed vs no cache")
