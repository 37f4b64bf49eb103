"""Wrappers of the stoch_quant Triton kernel.

``stoch_quant`` routes by the tensors' device: CUDA launches the kernel,
CPU runs the plain version of ``ref.py``. ``quantize_with_uniforms`` is the
codec-facing form (the port's ``quantize_with_keys``): it takes the round's
uniforms instead of PRNG keys, reduces the per-client ranges outside the
kernel, and returns what goes on the wire: the levels and the ranges.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.stoch_quant.ref import stoch_quant_ref
from repro_torch.kernels.stoch_quant.stoch_quant import stoch_quant_triton


def stoch_quant(y, y_hat_prev, u, R, *, bits: int):
    """(levels int32, ŷ') of eqs. 25-30 for an (n, N) batch and (n,) ranges."""
    if dispatch.kernel_route(y, "stoch_quant"):
        return stoch_quant_triton(y, y_hat_prev, u, R, bits=bits)
    return stoch_quant_ref(y, y_hat_prev, u, R, bits=bits)


def quantize_with_uniforms(u: torch.Tensor, y: torch.Tensor,
                           y_hat_prev: torch.Tensor, bits: int):
    """Batched eqs. 25-30 over a leading client axis with the round's
    uniforms ``u`` (same shape as ``y``): ``(levels (n, N) int32, R (n,))``."""
    R = torch.amax(torch.abs(y - y_hat_prev), dim=-1)
    levels, _ = stoch_quant(y, y_hat_prev, u, R, bits=bits)
    return levels, R
