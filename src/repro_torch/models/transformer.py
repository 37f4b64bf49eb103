"""Block composer (port of ``repro.models.transformer``).

The JAX package stacks each pattern position's params over the R repeats
and scans them. Serving here runs eagerly under ``torch.inference_mode()``,
so the port keeps a plain list of layers in JAX's order: repeat r, pattern
position p is layer ``r * len(pattern) + p``; the ``tail_len`` tail layers
(the pattern's first kinds) follow. No scan and no remat.

Block kinds ported so far, with their caches:
  'global'/'local' : self-attention + dense FFN; cache {k, v}
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_init, rmsnorm, rmsnorm_init

ATTN_KINDS = ("global", "local")


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise ValueError(f"block kind {kind!r} is not ported (have {ATTN_KINDS})")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's block kind, in the JAX package's order."""
    pat = list(cfg.layer_pattern)
    return pat * cfg.pattern_repeats + pat[: cfg.tail_len]


def block_init(gen, cfg: ModelConfig, kind: str, device) -> dict:
    _check_kind(cfg, kind)
    dtype = param_dtype(cfg)
    D = cfg.d_model
    return {
        "norm1": rmsnorm_init(D, dtype, device),
        "attn": attn.attn_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(D, dtype, device),
        "ffn": mlp_init(gen, D, cfg.d_ff, dtype, device),
    }


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device) -> dict:
    """Decode-time cache for one block: local layers keep a ring of
    ``min(window, max_len)`` positions, global layers all ``max_len``."""
    _check_kind(cfg, kind)
    L = min(cfg.window, max_len) if (kind == "local" and cfg.window) else max_len
    shape = (batch, L, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=act_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=act_dtype(cfg), device=device)}


def block_apply(params: dict, cfg: ModelConfig, kind: str, x, positions,
                cache=None, decode: bool = False):
    """Returns (x, cache)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    y, cache = attn.self_attention(params["attn"], cfg, h, kind, positions,
                                   cache, decode)
    x = x + y
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2, cfg.mlp_act), cache


# ---------------------------------------------------------------------------
# layer stack
# ---------------------------------------------------------------------------


def stack_init(gen, cfg: ModelConfig, device) -> List[dict]:
    return [block_init(gen, cfg, kind, device) for kind in layer_kinds(cfg)]


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     device) -> List[dict]:
    return [block_cache_init(cfg, kind, batch, max_len, device)
            for kind in layer_kinds(cfg)]


def stack_apply(layers: List[dict], cfg: ModelConfig, x, positions,
                caches: List[dict] | None = None, decode: bool = False):
    """Every layer in order. Returns (x, caches)."""
    for i, (params, kind) in enumerate(zip(layers, layer_kinds(cfg))):
        c = None if caches is None else caches[i]
        x, _ = block_apply(params, cfg, kind, x, positions, c, decode)
    return x, caches
