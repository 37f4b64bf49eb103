"""Shared neural building blocks (port of ``repro.models.layers``).

Params are nested dicts of tensors; every layer is a pair of functions
``*_init(gen, ...) -> params`` and ``apply(params, x, ...) -> y``. Compute
runs in the activation dtype with float32 where the JAX package takes it
(norm statistics, rope angles, softmax, softcap); params live in the
parameter dtype and are cast to the activation dtype at use, as JAX's
``dense`` does. Initialisers draw from an explicit ``torch.Generator`` on
the target device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w.mul_(scale)).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device) -> dict:
    return {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                         dtype, device)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device) -> dict:
    # std 1/sqrt(dim): with the gemma sqrt(d) embed_scale this gives unit-RMS
    # residual-stream inputs and O(1) logits through the tied readout.
    return {"table": _normal(gen, (vocab, dim), 1.0 / math.sqrt(dim), dtype,
                             device)}


def embed(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same values as JAX's cast-then-gather without
    # casting the whole table
    return params["table"][tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: x @ table^T."""
    return x @ params["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# RMSNorm (gemma-style: weight is a residual offset from 1)
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype, device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype, device),
        "up": dense_init(gen, d_model, d_ff, dtype, device),
        "down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = dense(params["gate"], x)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return dense(params["down"], g * dense(params["up"], x))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     exponent)
    angles = positions[..., None].float() * freq  # (..., S, half)
    angles = angles[..., None, :]  # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
