"""Stochastic quantization for Q-FedNew (paper Sec. 5, eqs. 25-30).

Counterpart of ``repro.core.quantization``. Client i quantizes the
difference between its new direction ``y`` and the previously quantized
vector ``y_hat_prev``:

    R     = max_j |y_j - y_hat_prev_j|          (quantization half-range)
    Delta = 2 R / (2^bits - 1)
    c_j   = (y_j - y_hat_prev_j + R) / Delta    (eq. 25; non-negative)
    q_j   = ceil(c_j) w.p. frac(c_j), else floor(c_j)   (eqs. 26, 28)
    y_hat = y_hat_prev + Delta * q - R          (eq. 30)

The uniforms are an explicit argument: the port draws them from the
solver's ``torch.Generator`` and the tests hand in the JAX package's.

Bit counts are exact Python ints; the per-round metric lowers them to an
int64 tensor, exact at any scale.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

R_BITS = 32  # bits used to transmit the scalar range R per message


def payload_bits(bits: int, d: int, *, r_bits: int = R_BITS) -> int:
    """Exact uplink bits for one quantized message: ``bits``·d + ``r_bits``."""
    return bits * d + r_bits


def exact_payload_bits(d: int, dtype_bits: int = 32) -> int:
    """Bits per message of a full-precision vector; ``dtype_bits`` is the
    word size of the transmitted dtype (:func:`word_bits`)."""
    return dtype_bits * d


def word_bits(x: Union[torch.Tensor, torch.dtype]) -> int:
    """Bits per element of a tensor (or dtype) as it crosses the wire."""
    dtype = x.dtype if isinstance(x, torch.Tensor) else x
    return 8 * dtype.itemsize


def payload_bits_array(value: int, device) -> torch.Tensor:
    """An exact Python-int bit count as an int64 scalar tensor on ``device``
    (a fill, not a host-to-device copy)."""
    return torch.full((), value, dtype=torch.int64, device=device)


def step_size(R: torch.Tensor, bits: int) -> torch.Tensor:
    """Δ = 2R / (2^bits - 1), correctly rounded on every device. The divisor
    is a tensor on purpose: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can miss the IEEE quotient by an
    ulp, and the levels depend on the last bit of Δ."""
    return 2.0 * R / torch.full_like(R, (1 << bits) - 1)


class QuantResult(NamedTuple):
    y_hat: torch.Tensor  # dequantized vectors the PS reconstructs
    levels: torch.Tensor  # int32 levels actually transmitted (the payload)
    delta: torch.Tensor  # per-client step size
    payload_bits: torch.Tensor  # per-client bits on the wire


def quantize(u: torch.Tensor, y: torch.Tensor, y_hat_prev: torch.Tensor,
             bits: int) -> QuantResult:
    """Plain eqs. 25-30 over a leading client axis (one range per row),
    given the uniforms ``u`` (same shape as ``y``) — the reference route."""
    diff = y - y_hat_prev
    R = torch.amax(torch.abs(diff), dim=-1, keepdim=True)
    n_levels = (1 << bits) - 1
    delta = step_size(R, bits)
    # Guard the all-zero-diff round: keep c finite; y_hat falls back to prev.
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    c = (diff + R) / safe_delta
    lo = torch.floor(c)
    q = lo + (u < c - lo).to(y.dtype)
    q = torch.clamp(q, 0, n_levels)
    y_hat = y_hat_prev + delta * q - R
    payload = payload_bits_array(payload_bits(bits, y.shape[-1]), y.device)
    return QuantResult(y_hat=y_hat, levels=q.to(torch.int32),
                       delta=delta.squeeze(-1),
                       payload_bits=payload.expand(y.shape[0]))
