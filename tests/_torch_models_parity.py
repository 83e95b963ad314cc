"""Shared helpers of the model tests (``test_torch_models.py``,
``test_torch_moe.py``, ``test_torch_ssm.py``, ``test_torch_encdec.py``):
the reference's parameters converted to the port's, inputs from a seed,
comparisons, and taps on both packages' MoE routing.  Imports JAX; the
card tests do not use it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jax_configs
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro_torch import configs
from repro_torch.models import encdec, layers, lm

CPU = "cpu"
F32, BF16 = 1e-4, 4e-2
TOL = {"float32": F32, "bfloat16": BF16}
#: a routing that differs between the packages is accepted only where the
#: reference's probabilities of the two experts it swapped lie within this
#: relative gap: float32 sums in another order move them by about 1e-7;
#: at bf16 the activations reaching the router differ by a few bf16 ulps
#: (the logits' own limit, ``BF16``), so a near tie at that scale may flip
TIE = {"float32": 1e-6, "bfloat16": BF16}
NORMS = {"ln1", "ln2", "pn1", "pn2", "ln_f", "q_norm", "k_norm", "kv_norm",
         "out_norm", "ln_x", "enc_ln"}
#: the SSD block's float32 scalars per head, drawn from a seed as normals
#: of these scales (at their initial 0, 1, 0, A = -exp(A_log) = -1 would
#: hide a sign or an exp error)
SSM_SCALARS = {"A_log": 0.5, "D": 1.0, "dt_bias": 0.5}


def host(x) -> np.ndarray:
    """A tensor or a JAX array (bf16 included) as a float32/int NumPy
    copy."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).numpy()
    x = jnp.asarray(x)
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def paths(tree, path: str = "") -> dict:
    """{"/a/b": leaf} over a dict tree, keys sorted (the order in which
    ``jax.tree_util`` flattens it)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in paths(tree[key], f"{path}/{key}").items()}
    return {path: tree}


def assert_close(port, ref, tol: float, what: str, rows=None) -> None:
    """max |port - ref| <= tol x max |ref|, over the leading-axis ``rows``
    when given."""
    a, b = host(port), host(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if rows is not None:
        assert len(rows), f"{what}: no row left to compare"
        a, b = a[rows], b[rows]
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * scale, \
        f"{what}: max|d| {err:.3g} > {tol} x max|ref| {scale:.3g}"


def assert_cache(port, ref, tol: float, rows=None, path="cache") -> None:
    """The same cache entries: every one close (the attention caches' GQA
    k/v or MLA c/kr, the SSM's state and conv tail, the encoder-decoder's
    self-attention k/v and encoder states ``enc``), the positions equal.
    ``rows`` picks batch rows: axis 1 of the entries stacked by layer,
    axis 0 of ``enc``."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in port:
            assert_cache(port[k], ref[k], tol, rows, f"{path}[{k!r}]")
    elif path.endswith("['pos']"):
        np.testing.assert_array_equal(host(port), host(ref))
    else:
        assert_close(port, ref, tol, path, rows=None if rows is None else (
            rows if path == "cache['enc']" else (slice(None), rows)))


def ref_params(cfg, seed: int):
    """The reference's parameters with every norm scale non-zero and the
    SSM's ``A_log``, ``D`` and ``dt_bias`` drawn from the seed."""
    init = jax_encdec.init_params if cfg.family == "encdec" \
        else jax_lm.init_params
    p = init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        key = path[-1].key
        if key in NORMS:
            return jnp.asarray(rng.standard_normal(x.shape) * 0.5, x.dtype)
        if key in SSM_SCALARS:
            return jnp.asarray(rng.standard_normal(x.shape)
                               * SSM_SCALARS[key], x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, p)


def both_params(arch: str, dtype: str, seed: int = 1, **kw):
    """(reference config, params), (port config, params): the same
    weights, the port's from the reference's tree as NumPy float32."""
    jcfg = jax_configs.get_smoke(arch).scaled(dtype=dtype, **kw)
    tcfg = configs.get_smoke(arch).scaled(dtype=dtype, **kw)
    jp = ref_params(jcfg, seed)
    tree = jax.tree.map(lambda x: host(x), jp)
    return (jcfg, jp), (tcfg, lm.params_from_numpy(tree, tcfg, device=CPU))


def inputs(cfg, B: int, S: int, seed: int = 0):
    """Tokens (B, S) and the model's other input, float32 or None: a VLM's
    prefix embeddings (B, vision_len, d), an encoder-decoder's stub frames
    (B, encoder_len, d)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = None
    extra = {"vlm": cfg.vision_len, "encdec": cfg.encoder_len}
    if cfg.family in extra:
        pe = rng.standard_normal((B, extra[cfg.family], cfg.d_model)).astype(
            np.float32)
    return toks, pe


def port_init(cfg):
    """The port's ``init_params`` of ``cfg``'s family."""
    return encdec.init_params if cfg.family == "encdec" else lm.init_params


def jx(a):
    return None if a is None else jnp.asarray(a)


def encdec_matches(jcfg, jp, tcfg, tp, frames, toks, ctx: int, tol: float,
                   pos: int | None = None) -> None:
    """The encoder-decoder in both packages: ``decode_train`` over every
    token, ``prefill`` on all but the last (logits, the self-attention cache
    of ``ctx`` slots and the encoder states), and a decode step of the last
    at ``pos`` (by default the next position)."""
    B, S = toks.shape
    ref = jax_encdec.decode_train(jp, jcfg, jnp.asarray(frames),
                                  jnp.asarray(toks))
    got = encdec.decode_train(tp, tcfg, frames, toks, device=CPU)
    assert got.dtype == torch.float32
    assert_close(got, ref, tol, "decode_train")
    jc = jax_encdec.init_cache(jcfg, B, ctx)
    tc = encdec.init_cache(tcfg, B, ctx, device=CPU)
    ref, jc = jax_encdec.prefill(jp, jcfg, jnp.asarray(frames),
                                 jnp.asarray(toks[:, :-1]), jc)
    got, tc = encdec.prefill(tp, tcfg, frames, toks[:, :-1], tc, device=CPU)
    assert_close(got, ref, tol, "prefill")
    assert_cache(tc, jc, tol)
    at = np.full((B,), S - 1 if pos is None else pos, np.int32)
    ref, jc = jax_encdec.decode_step(jp, jcfg, jnp.asarray(toks[:, -1:]),
                                     jnp.asarray(at), jc)
    got, tc = encdec.decode_step(tp, tcfg, toks[:, -1:], at, tc, device=CPU)
    assert_close(got, ref, tol, "decode")
    assert_cache(tc, jc, tol)


# ---------------------------------------------------------------------------
# MoE routing, tapped in both packages


class Routings:
    """Every MoE routing both packages make while installed (``install``):
    the reference's router probabilities, top-k ids and capacity slots
    (taken from its own ``jax.lax.top_k`` and ``jax.nn.one_hot`` calls,
    through ``jax.debug.callback``, so inside its layer scan too), and the
    port's ``layers.Routing`` objects, each in call order."""

    def __init__(self):
        self.ref, self.port = [], []
        self.checked = 0        # routings compared by ``flipped_rows``

    def install(self, monkeypatch) -> "Routings":
        top_k, one_hot, route = jax.lax.top_k, jax.nn.one_hot, \
            layers.moe_route

        def keep_top_k(probs, k):
            vals, ids = top_k(probs, k)
            jax.debug.callback(lambda p, i: self.ref.append(
                [np.asarray(p), np.asarray(i)]), probs, ids, ordered=True)
            return vals, ids

        def keep_slots(x, *a, **kw):
            if jnp.issubdtype(x.dtype, jnp.floating):    # the slots' call
                jax.debug.callback(lambda s: self.ref[-1].append(
                    np.asarray(s).astype(np.int64)), x, ordered=True)
            return one_hot(x, *a, **kw)

        def keep_route(p, cfg, xg):
            r = route(p, cfg, xg)
            self.port.append(r)
            return r

        monkeypatch.setattr(jax.lax, "top_k", keep_top_k)
        monkeypatch.setattr(jax.nn, "one_hot", keep_slots)
        monkeypatch.setattr(layers, "moe_route", keep_route)
        return self

    def flipped_rows(self, B: int, tie: float, flipped=()) -> set:
        """Check the routings recorded since the last call, in order: ids
        equal, except tokens whose first differing choice was a near tie in
        the reference (its probabilities of the two experts within ``tie``
        of each other, relative), and the slots of every group without such
        a token equal.  A batch row (of B) in ``flipped``, or that holds
        such a token, is another sequence from there on: its tokens are
        not compared in later calls.  Returns those rows."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port), (len(self.ref),
                                                 len(self.port))
        rows = set(flipped)
        for (probs, ids, slots), r in zip(self.ref, self.port):
            pid, psl = r.ids.numpy(), r.slots.numpy()
            assert ids.shape == pid.shape and slots.shape == psl.shape
            G, g, _ = ids.shape
            per_row = G * g // B
            new = set()
            for gi in range(G):
                bad = np.flatnonzero((ids[gi] != pid[gi]).any(-1))
                if not bad.size:
                    np.testing.assert_array_equal(psl[gi], slots[gi])
                for t in bad:
                    row = (gi * g + int(t)) // per_row
                    if row in rows:
                        continue
                    j = int(np.argmax(ids[gi, t] != pid[gi, t]))
                    p = np.sort(probs[gi, t])[::-1]
                    assert p[j] - p[j + 1] <= tie * p[j], (
                        f"group {gi} token {t}: ids {pid[gi, t]} vs the "
                        f"reference's {ids[gi, t]}, probabilities "
                        f"{p[j]:.8g} and {p[j + 1]:.8g} are no near tie")
                    new.add(row)
            rows |= new
        self.checked += len(self.ref)
        self.ref, self.port = [], []
        return rows
