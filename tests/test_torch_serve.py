"""The port's LM serving path (gemma3-4b's family) against the JAX
package, on the CPU.

The model is gemma3-4b reduced to a laptop size. ``reduced()`` keeps
``layer_pattern[:2]``, which for gemma3 is two local layers, so the parity
config puts a global layer in and adds a one-layer tail: pattern
(local, global), 3 layers = 1 repeat + 1 tail layer, on both sides. Params
are built by JAX and carried over with ``convert.lm_params_from_numpy``;
tokens come from each package's own ``make_batch`` (the same numpy stream).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np32, t
from repro.configs.base import InputShape as JaxInputShape
from repro.configs.registry import get_config as jax_get_config
from repro.data.tokens import make_batch as jax_make_batch
from repro.models import lm as jax_lm
from repro_torch import convert
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.data.tokens import make_batch
from repro_torch.launch.serve import serve
from repro_torch.models import lm, transformer

# Whole-model f32 logits and caches through 3 layers in two frameworks:
# the bound of tests/test_integration_extra.py:42-45.
MODEL = dict(rtol=2e-4, atol=2e-4)
THREE_LAYERS = dict(layer_pattern=("local", "global"), n_layers=3)
B, S = 2, 32


def _cfgs(**kw):
    kw = {**THREE_LAYERS, **kw}
    return (dataclasses.replace(get_config("gemma3-4b").reduced(), **kw),
            dataclasses.replace(jax_get_config("gemma3-4b").reduced(), **kw))


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, port params, JAX params, tokens (B, S + 8))."""
    tcfg, jcfg = _cfgs()
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    tokens = jax_make_batch(jcfg, JaxInputShape("p", S + 8, B, "prefill"), 3)
    return tcfg, jcfg, tparams, jparams, np.asarray(tokens["tokens"])


def _jax_caches(caches, cfg):
    """JAX's {scan: [per position, stacked over repeats], tail} -> a list in
    the port's layer order."""
    out = [jax.tree.map(lambda a, r=r: a[r], caches["scan"][p])
           for r in range(cfg.pattern_repeats)
           for p in range(len(cfg.layer_pattern))]
    return out + list(caches["tail"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(model, use_pallas):
    """Last-position logits and every layer's caches (local rings of 16 and
    the global cache) against JAX's prefill on both of its routes."""
    tcfg, jcfg, tparams, jparams, tokens = model
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    want, want_caches = jax_lm.prefill(jparams, jcfg, {"tokens": tokens[:, :S]},
                                       max_len=S + 8)
    with torch.inference_mode():
        got, got_caches = lm.prefill(tparams, tcfg,
                                     {"tokens": t(tokens[:, :S])},
                                     max_len=S + 8)
    np.testing.assert_allclose(got.numpy(), np32(want), **MODEL)
    want_caches = _jax_caches(want_caches, jcfg)
    assert [c["k"].shape[1] for c in got_caches] == [16, S + 8, 16]
    for g, w in zip(got_caches, want_caches):
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), np32(w[name]), **MODEL)


def test_prefill_bf16_activations_match_jax(model):
    """bf16 activations (gemma3-4b's own), f32 params. The two frameworks
    round to bf16 at other places (the local layers' probabilities stay f32
    in the port's kernel and are rounded in JAX's band code; gelu runs in
    f32 inside PyTorch), so the bound is a few bf16 ulps of the largest
    logit: 4 * 2**-8 * max|logit|."""
    tcfg, jcfg, tparams, jparams, tokens = model
    tcfg = dataclasses.replace(tcfg, activation_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, activation_dtype="bfloat16")
    want, _ = jax_lm.prefill(jparams, jcfg, {"tokens": tokens[:, :S]})
    with torch.inference_mode():
        got, caches = lm.prefill(tparams, tcfg,
                                 {"tokens": t(tokens[:, :S])})
    assert got.dtype == torch.bfloat16 and caches[0]["k"].dtype == torch.bfloat16
    want = np32(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=4 * 2.0 ** -8 * np.abs(want).max())


def test_decode_after_prefill_matches_full_forward_and_jax(model):
    """Prefill S-1 tokens, decode token S-1: the logits equal the full
    forward's last position (the relative 5e-2 bound of
    tests/test_arch_smoke.py:83) and JAX's decode logits (rtol 2e-4)."""
    tcfg, jcfg, tparams, jparams, tokens = model
    toks = tokens[:, :S]
    with torch.inference_mode():
        feats, _ = lm.backbone(tparams, tcfg, {"tokens": t(toks)})
        ref = lm.logits_fn(tparams, tcfg, feats[:, -1:])
        _, caches = lm.prefill(tparams, tcfg,
                               {"tokens": t(toks[:, :-1])},
                               max_len=S)
        pos = torch.full((B,), S - 1, dtype=torch.int32)
        got, _ = lm.decode_step(tparams, tcfg, t(toks[:, -1:]),
                                pos, caches)
    err = (got - ref).abs().max() / (ref.abs().max() + 1e-6)
    assert err.item() < 5e-2
    _, jcaches = jax_lm.prefill(jparams, jcfg, {"tokens": toks[:, :-1]},
                                max_len=S)
    want, _ = jax_lm.decode_step(jparams, jcfg, toks[:, -1:],
                                 jnp.full((B,), S - 1, jnp.int32), jcaches)
    np.testing.assert_allclose(got.numpy(), np32(want), **MODEL)


def test_serve_generates_jax_greedy_tokens(model):
    """``serve`` over 8 greedy tokens (the local rings wrap past S = 32)
    gives the ids of the same loop written with JAX's prefill/decode_step."""
    tcfg, jcfg, tparams, jparams, tokens = model
    gen = 8
    toks = tokens[:, :S]
    with torch.inference_mode():
        got = serve(tcfg, tparams, t(toks), gen)
    logits, caches = jax_lm.prefill(jparams, jcfg, {"tokens": toks},
                                    max_len=S + gen)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        pos = jnp.full((B,), S + i, jnp.int32)
        logits, caches = jax_lm.decode_step(jparams, jcfg, tok[:, None], pos,
                                            caches)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        want.append(tok)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


@pytest.mark.parametrize("seq,batch,seed", [(16, 2, 0), (33, 3, 5)])
def test_make_batch_tokens_equal_jax(seq, batch, seed):
    cfg = get_config("gemma3-4b")
    got = make_batch(cfg, InputShape("s", seq, batch, "prefill"), seed,
                     device="cpu")
    want = jax_make_batch(jax_get_config("gemma3-4b"),
                          JaxInputShape("s", seq, batch, "prefill"), seed)
    for name in ("tokens", "targets", "loss_mask"):
        assert got[name].dtype == getattr(torch, str(want[name].dtype))
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_jax(reduced):
    """Every field the port's config has equals JAX's field of that name."""
    cfg, jcfg = get_config("gemma3-4b"), jax_get_config("gemma3-4b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.resolved_head_dim, cfg.pattern_repeats, cfg.tail_len) == \
        (jcfg.resolved_head_dim, jcfg.pattern_repeats, jcfg.tail_len)
    kinds = transformer.layer_kinds(cfg)
    assert len(kinds) == cfg.n_layers
    if not reduced:  # 5 x (5 local + 1 global) + a 4-layer local tail
        assert kinds.count("local") == 29 and kinds.count("global") == 5
        assert [i for i, k in enumerate(kinds) if k == "global"] == [5, 11, 17, 23, 29]


def test_config_registry_has_only_ported_archs():
    assert get_config("gemma3-4b").n_layers == 34
    with pytest.raises(KeyError):
        get_config("xlstm-350m")


def test_params_carry_over_exactly(model):
    """Every JAX leaf lands bitwise in the port's layer order, and nothing
    else is there."""
    tcfg, jcfg, tparams, jparams, _ = model
    jleaves = jax.tree.leaves(jparams)
    tleaves = jax.tree.leaves(tparams)  # the port's params are plain dicts/lists
    assert len(tleaves) == len(jleaves)
    assert sum(x.numel() for x in tleaves) == sum(x.size for x in jleaves)
    for t_leaf in tleaves:
        assert t_leaf.dtype == torch.float32 and t_leaf.device.type == "cpu"
    jblocks = jparams["blocks"]
    for r in range(jcfg.pattern_repeats):
        for p in range(len(jcfg.layer_pattern)):
            layer = tparams["blocks"][r * len(jcfg.layer_pattern) + p]
            for path, leaf in jax.tree_util.tree_leaves_with_path(jblocks["scan"][p]):
                got = layer
                for key in path:
                    got = got[key.key]
                np.testing.assert_array_equal(got.numpy(), np.asarray(leaf)[r])
    for t_i, tail in enumerate(jblocks["tail"]):
        layer = tparams["blocks"][jcfg.pattern_repeats * len(jcfg.layer_pattern) + t_i]
        for path, leaf in jax.tree_util.tree_leaves_with_path(tail):
            got = layer
            for key in path:
                got = got[key.key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tparams["embed"]["table"].numpy(),
                                  np.asarray(jparams["embed"]["table"]))
    np.testing.assert_array_equal(tparams["final_norm"]["scale"].numpy(),
                                  np.asarray(jparams["final_norm"]["scale"]))


def test_init_params_shapes_and_seeding():
    """The port's own initialiser: JAX's leaf shapes, seeded by its
    generator, norm scales zero, dense weights ~ N(0, 1/in)."""
    tcfg, jcfg = _cfgs()
    gen = torch.Generator().manual_seed(1)
    a = lm.init_params(tcfg, gen, "cpu")
    b = lm.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    want = jax.eval_shape(lambda: jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = convert.lm_params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want), tcfg,
        device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), a)
    assert shapes == jax.tree.map(lambda x: tuple(x.shape), want)
    assert all(torch.equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert not a["blocks"][0]["norm1"]["scale"].any()
    w = a["blocks"][0]["ffn"]["down"]["w"]
    assert abs(w.std().item() * np.sqrt(tcfg.d_ff) - 1.0) < 0.05
