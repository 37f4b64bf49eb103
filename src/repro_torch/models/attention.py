"""GQA attention, prefill + decode (port of ``repro.models.attention``).

Prefill never materializes (S x S) scores. A ``local`` (sliding-window)
layer always goes through the ``swa_attention`` kernel wrapper: on a CUDA
tensor that launches the hand-written kernel, on a CPU tensor it runs the
kernel's plain band recurrence. A ``global`` layer runs the chunked
online-softmax recurrence of the JAX package in plain PyTorch (JAX computes
it outside any Pallas kernel too); query chunks skip the key chunks that lie
wholly after them, which the causal mask would zero exactly.

Decode attends one query position against the KV cache with plain matrix
products and a masked softmax. Local caches of length ``window`` are rings
(slot ``pos % window``). Prefill fills the caches and decode writes its
slot in place: the port updates the cache tensors it is given instead of
returning fresh copies as JAX does.

Scores are float32 (JAX's ``preferred_element_type``): the operands are
widened before the product, so bf16 products are exact and summed in
float32. Cross, bidirectional and MoE attention are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models.layers import dense, dense_init, rmsnorm, rmsnorm_init, rope, softcap

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    dh = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, dtype, device),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(dh, dtype, device)
        p["knorm"] = rmsnorm_init(dh, dtype, device)
    return p


def _project_qkv(params, cfg: ModelConfig, xq, xkv):
    dh = cfg.resolved_head_dim
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    q = dense(params["wq"], xq).reshape(B, Sq, cfg.n_heads, dh)
    k = dense(params["wk"], xkv).reshape(B, Skv, cfg.n_kv_heads, dh)
    v = dense(params["wv"], xkv).reshape(B, Skv, cfg.n_kv_heads, dh)
    if "qnorm" in params:
        q = rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(params["knorm"], k, cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# core softmax-attention tiles
# ---------------------------------------------------------------------------


def _scores(q, k, scale, cap):
    """q (B,Q,Hkv,G,Dh) x k (B,K,Hkv,Dh) -> (B,Hkv,G,Q,K) in float32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    return softcap(s * scale, cap)


def _pv(p, v):
    """p (B,Hkv,G,Q,K) cast to v's dtype, as JAX does, then summed in
    float32 against v (B,K,Hkv,Dh) -> (B,Hkv,G,Q,Dh)."""
    return torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())


def _online_update(m, l, acc, s, v, mask):
    """One online-softmax accumulation step. s (B,Hkv,G,Q,K) float32."""
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + _pv(p, v)
    return m_new, l, acc


def _finalize(l, acc, dtype):
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# prefill attention over full sequences
# ---------------------------------------------------------------------------


def causal_attention(q, k, v, cfg: ModelConfig, *, window: int | None,
                     cap: float | None):
    """Chunked causal (optionally sliding-window) attention.

    q (B,S,H,Dh), k/v (B,S,Hkv,Dh) -> (B,S,H,Dh).
    """
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qc = min(cfg.attn_q_chunk, S)
    if S % qc:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"query chunk {qc} (attn_q_chunk={cfg.attn_q_chunk})")
    if window:
        return swa_ops.swa_attention(q, k, v, window=window, cap=cap)

    # Full causal: query chunks, each with the online-softmax recurrence over
    # the key chunks that start at or before its last query.
    kc = min(cfg.attn_kv_chunk, S)
    if S % kc:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"key chunk {kc} (attn_kv_chunk={cfg.attn_kv_chunk})")
    scale = Dh ** -0.5
    q5 = q.reshape(B, S, Hkv, G, Dh)
    out = torch.empty_like(q)
    for q0 in range(0, S, qc):
        qi = q5[:, q0:q0 + qc]
        qpos = torch.arange(q0, q0 + qc, device=q.device)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, qc, Dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, q0 + qc, kc):
            kpos = torch.arange(k0, k0 + kc, device=q.device)
            valid = kpos[None, :] <= qpos[:, None]
            s = _scores(qi, k[:, k0:k0 + kc], scale, cap)
            m, l, acc = _online_update(m, l, acc, s, v[:, k0:k0 + kc], valid)
        # (B,Hkv,G,qc,Dh) -> (B,qc,H,Dh)
        out[:, q0:q0 + qc] = _finalize(l, acc, q.dtype).permute(0, 3, 1, 2, 4) \
            .reshape(B, qc, H, Dh)
    return out


def decode_attention(q, k_cache, v_cache, valid, cap: float | None):
    """One-token decode. q (B,1,H,Dh); caches (B,L,Hkv,Dh); valid (B,L) bool."""
    B, _, H, Dh = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    q5 = q.reshape(B, 1, Hkv, G, Dh)
    s = _scores(q5, k_cache, Dh ** -0.5, cap)  # (B,Hkv,G,1,L)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = _pv(p / l, v_cache).to(v_cache.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, Dh)


# ---------------------------------------------------------------------------
# layer-level apply (projections + rope + cache handling)
# ---------------------------------------------------------------------------


def self_attention(params, cfg: ModelConfig, x, kind: str, positions,
                   cache: dict | None = None, decode: bool = False):
    """Returns (y, cache). Prefill without a cache returns None for it; with
    one (from ``transformer.block_cache_init``) it writes k/v into it. Decode
    writes the current position's k/v into the cache and attends over it."""
    if kind not in ("global", "local"):
        raise ValueError(f"attention kind {kind!r} is not ported")
    window = cfg.window if kind == "local" else None
    theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
    q, k, v = _project_qkv(params, cfg, x, x)
    cap = cfg.attn_logit_softcap
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        L = cache["k"].shape[1]
        pos = positions[:, 0]  # (B,) current absolute position
        # Local caches are built with L == min(window, max_len): L == window
        # marks a ring buffer (pos can exceed L); L < window means the cache
        # covers every position and plain indexing is correct.
        is_ring = bool(window) and L == window
        slot = pos % window if is_ring else pos
        bidx = torch.arange(x.shape[0], device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        idx = torch.arange(L, device=x.device)[None, :]
        if is_ring:
            valid = idx < torch.clamp(pos + 1, max=window)[:, None]
        else:
            valid = idx <= pos[:, None]
        y = decode_attention(q, cache["k"], cache["v"], valid, cap)
    else:
        y = causal_attention(q, k, v, cfg, window=window, cap=cap)
        if cache is not None:  # prefill: write kv into the decode buffers
            S = k.shape[1]
            L = cache["k"].shape[1]
            if window and window < S:
                # keep the last `window` rows, ring-aligned so that decode's
                # slot = pos % window lands on the right rows (L == window)
                rows = torch.arange(S - window, S, device=x.device)
                ring = rows % L
                cache["k"][:, ring] = k[:, rows].to(cache["k"].dtype)
                cache["v"][:, ring] = v[:, rows].to(cache["v"].dtype)
            else:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
    return dense(params["wo"], y.reshape(*y.shape[:2], -1)), cache
