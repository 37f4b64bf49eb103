"""Causal LM: params, backbone, logits, and the serving pair prefill /
decode_step (port of ``repro.models.lm``).

  init_params(cfg, gen, device=None)                 -> params
  prefill(params, cfg, batch, max_len=None)          -> (last_logits, caches)
  decode_step(params, cfg, tokens, pos, caches)      -> (logits, caches)

Params: {"embed": {"table"}, "blocks": [layer dicts in JAX's order],
"final_norm": {"scale"}}; the readout is tied to the embedding. Batches are
dicts with tokens (B, S) int32. Training (the chunked CE), untied readouts,
the encoder-decoder and the VLM projector are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed, embed_init, rmsnorm, rmsnorm_init, softcap, unembed


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random params drawn from ``gen``, a generator on ``device`` (the CUDA
    card unless another is named)."""
    dev = resolve_device(device)
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied readouts are not ported yet")
    pdt = tfm.param_dtype(cfg)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pdt, dev),
        "blocks": tfm.stack_init(gen, cfg, dev),
        "final_norm": rmsnorm_init(cfg.d_model, pdt, dev),
    }


def _embed_tokens(params, cfg: ModelConfig, tokens):
    x = embed(params["embed"], tokens, tfm.act_dtype(cfg))
    if cfg.embed_scale:
        # sqrt(d_model) rounded to float32, then to the activation dtype
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        x = x * scale.to(device=x.device, dtype=x.dtype)
    return x


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Token embedding. Returns (x, positions)."""
    x = _embed_tokens(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def backbone(params, cfg: ModelConfig, batch, caches=None, decode=False,
             positions=None):
    """Features (B, S, D) after the final norm, and the caches."""
    if decode:
        x = _embed_tokens(params, cfg, batch["tokens"])
    else:
        x, positions = _embed_inputs(params, cfg, batch)
    x, caches = tfm.stack_apply(params["blocks"], cfg, x, positions, caches,
                                decode)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def logits_fn(params, cfg: ModelConfig, feats):
    return softcap(unembed(params["embed"], feats), cfg.final_logit_softcap)


def prefill(params, cfg: ModelConfig, batch, max_len: int | None = None):
    """Run the whole prompt, build the decode caches (sized for ``max_len``
    total positions, the prompt's length by default), and return the last
    position's logits (B, 1, V)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    caches = tfm.stack_cache_init(cfg, B, max_len or S, tokens.device)
    feats, caches = backbone(params, cfg, batch, caches)
    return logits_fn(params, cfg, feats[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, tokens, pos, caches):
    """One-token decode. tokens (B, 1) int; pos (B,) absolute positions.
    Writes the caches in place and returns (logits (B, 1, V), caches)."""
    feats, caches = backbone(params, cfg, {"tokens": tokens}, caches,
                             decode=True, positions=pos[:, None])
    return logits_fn(params, cfg, feats), caches
