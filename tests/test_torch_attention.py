"""The port's sliding-window attention kernel module and attention layer
against the JAX package, on the CPU.

On the CPU the ``swa_attention`` wrapper runs the kernel's plain band
recurrence, so these tests hold the plain version (and the naive full-mask
oracle) against JAX's Pallas kernel in interpret mode and JAX's oracle, and
the port's attention layer against JAX's for both of JAX's routes
(``use_pallas`` False: the jnp band code; True: the Pallas kernel). The
CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``. Inputs are numpy arrays from a seed, handed to both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np32, t, tree_t
from repro.configs.registry import get_config as jax_get_config
from repro.kernels.swa_attention import ops as jax_swa_ops
from repro.kernels.swa_attention.ref import swa_attention_ref as jax_swa_ref
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tfm
from repro_torch.configs.registry import get_config
from repro_torch.kernels import dispatch, registered_kernels
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention.ref import swa_attention_plain, swa_attention_ref
from repro_torch.models import attention, transformer

# tests/test_kernels.py:42-46: the same f32 arithmetic with sums in another
# order; in bf16 the inputs are rounded and the output is rounded once.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# One attention layer, f32, two frameworks: projections, rope and the
# softmax recurrence with sums taken in another order.
LAYER = dict(rtol=2e-4, atol=2e-4)


def _qkv(S, H, Hkv, Dh, seed, dtype="float32", B=2):
    """numpy float32 q, k, v, rounded to ``dtype``'s values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, Dh)) for h in (H, Hkv, Hkv)]
    return [np32(jnp.asarray(a, dtype)) for a in arrs]


def _heads_major(x):
    """(B, S, H, Dh) -> JAX's kernel rows (B*H, S, Dh)."""
    B, S, H, Dh = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, Dh)


# S, window, G, cap: every value of each knob meets both S and both dtypes
CASES = [(64, 16, 1, None), (64, 100, 2, 20.0), (64, 128, 2, None),
         (256, 16, 2, 20.0), (256, 100, 1, None), (256, 128, 1, 20.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,G,cap", CASES)
def test_swa_plain_and_ref_match_jax(S, window, G, cap, dtype):
    """Both port versions against JAX's Pallas kernel (interpret mode) and
    JAX's full-mask oracle."""
    Hkv, Dh = 2, 32
    q, k, v = _qkv(S, Hkv * G, Hkv, Dh, seed=S + window + G, dtype=dtype)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    want_kernel = jax_swa_ops.swa_attention(jq, jk, jv, window=window, cap=cap,
                                            interpret=True)
    B = q.shape[0]
    want_ref = jax_swa_ref(_heads_major(jq), _heads_major(jk), _heads_major(jv),
                           window=window, groups=G, cap=cap)
    want_ref = np32(want_ref).reshape(B, Hkv * G, S, Dh).transpose(0, 2, 1, 3)
    tq, tk, tv = (t(x).to(getattr(torch, dtype)) for x in (q, k, v))
    tol = KERNEL_TOL[dtype]
    for fn in (swa_attention_plain, swa_attention_ref):
        got = fn(tq, tk, tv, window=window, cap=cap)
        assert got.dtype == tq.dtype
        for want in (np32(want_kernel), want_ref):
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("S", [200, 300])
def test_swa_plain_ragged_length_matches_jax_ref(S):
    """S no multiple of any tile (JAX's kernel refuses it): 200 is one short
    query chunk, 300 a full chunk of 256 and a ragged one of 44."""
    window, Hkv, G, Dh = 64, 2, 2, 32
    q, k, v = _qkv(S, Hkv * G, Hkv, Dh, seed=7)
    want = jax_swa_ref(_heads_major(q), _heads_major(k), _heads_major(v),
                       window=window, groups=G)
    want = np32(want).reshape(2, Hkv * G, S, Dh).transpose(0, 2, 1, 3)
    got = swa_attention_plain(t(q), t(k), t(v), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_swa_wrapper_routes_cpu_to_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    q, k, v = (t(x) for x in _qkv(64, 4, 2, 16, seed=1))
    dispatch.reset_launches()
    got = swa_ops.swa_attention(q, k, v, window=16, cap=30.0)
    assert torch.equal(got, swa_attention_plain(q, k, v, window=16, cap=30.0))
    assert dispatch.launches == {name: 0 for name in registered_kernels()}


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "groups", "window", "device"])
def test_swa_wrapper_rejects_bad_input(bad):
    q, k, v = (t(x) for x in _qkv(32, 4, 2, 16, seed=2))
    window = 8
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        k = k[:, :16]
    elif bad == "groups":  # 4 query heads over 3 kv heads
        k, v = (torch.cat([x, x[:, :, :1]], dim=2) for x in (k, v))
    elif bad == "window":
        window = 0
    else:  # neither CPU nor CUDA: no kernel and no plain route
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(ValueError):
        swa_ops.swa_attention(q, k, v, window=window)


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------


def _layer_cfgs(window):
    """gemma3-4b reduced (d 256, 4 heads of 64) with 2 kv heads (G = 2)."""
    kw = dict(n_kv_heads=2, window=window)
    return (dataclasses.replace(get_config("gemma3-4b").reduced(), **kw),
            dataclasses.replace(jax_get_config("gemma3-4b").reduced(), **kw))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("kind", ["local", "global"])
@pytest.mark.parametrize("window", [16, 64])  # S = 64: ring and linear caches
def test_self_attention_prefill_matches_jax(kind, use_pallas, window):
    """Output and the caches prefill writes (the last `window` rows placed
    ring-aligned when window < S), from the same carried-over params."""
    tcfg, jcfg = _layer_cfgs(window)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    B, S, max_len = 2, 64, 72
    jparams = jax_attn.attn_init(jax.random.PRNGKey(window), jcfg, jnp.float32)
    rng = np.random.default_rng(window)
    x = np32(rng.standard_normal((B, S, tcfg.d_model)))
    pos = np.broadcast_to(np.arange(S), (B, S))
    jcache = jax_tfm.block_cache_init(jcfg, kind, B, max_len)
    want, want_cache = jax_attn.self_attention(jparams, jcfg, x, kind, pos,
                                               jcache)
    tcache = transformer.block_cache_init(tcfg, kind, B, max_len, "cpu")
    got, got_cache = attention.self_attention(
        tree_t(jparams), tcfg, t(x), kind, torch.from_numpy(pos.copy()), tcache)
    np.testing.assert_allclose(got.numpy(), np32(want), **LAYER)
    for name in ("k", "v"):
        assert got_cache[name].shape == want_cache[name].shape
        np.testing.assert_allclose(got_cache[name].numpy(),
                                   np32(want_cache[name]), **LAYER)


def test_global_attention_needs_a_chunk_multiple():
    """The JAX precondition S % min(attn_q_chunk, S) == 0 is kept."""
    cfg, _ = _layer_cfgs(16)
    q, k, v = (t(x) for x in _qkv(40, 4, 2, 64, seed=4))  # 40 > 32, ragged
    for window in (None, 16):
        with pytest.raises(ValueError, match="multiple"):
            attention.causal_attention(q, k, v, cfg, window=window, cap=None)
