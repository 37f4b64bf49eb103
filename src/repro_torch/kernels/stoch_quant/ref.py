"""Plain PyTorch version of the stoch_quant kernel: paper eqs. 25-30 given
pre-drawn uniforms, the twin of ``repro.kernels.stoch_quant.ref``. Takes a
batched ``(n, N)`` block with per-row ``(n,)`` ranges, or one ``(N,)``
vector with a scalar range."""

from __future__ import annotations

import torch

from repro_torch.core.quantization import step_size


def stoch_quant_ref(y, y_hat_prev, u, R, *, bits: int):
    """-> (levels int32, ŷ') with ``y``'s shape."""
    yf = y.to(torch.float32)
    pf = y_hat_prev.to(torch.float32)
    n_levels = float((1 << bits) - 1)
    R = torch.as_tensor(R, dtype=torch.float32, device=y.device)
    R = R.reshape(-1, 1) if y.dim() == 2 else R.reshape(())
    delta = step_size(R, bits)
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    c = (yf - pf + R) / safe_delta
    lo = torch.floor(c)
    q = lo + (u.to(torch.float32) < (c - lo)).to(torch.float32)
    q = torch.clamp(q, 0.0, n_levels)
    return q.to(torch.int32), (pf + delta * q - R).to(y.dtype)
