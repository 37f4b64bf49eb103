"""Stochastic quantizer kernel for Q-FedNew (paper eqs. 25-30), in Triton.

Replaces ``src/repro/kernels/stoch_quant/stoch_quant.py::stoch_quant`` (the
Pallas TPU kernel, ``pl.pallas_call`` at line 80). Same contract: given the
batch of client directions ``y``, the previous quantized vectors ŷ, the
uniforms ``u`` (an input, so the kernel holds bit for bit against its plain
version under any generator) and the per-client ranges ``R`` (reduced
outside), every element computes

    Δ  = 2R / (2^bits - 1),   c = (y - ŷ + R) / Δ   (Δ = 0 guarded as 1)
    q  = clip(floor(c) + [u < frac(c)], 0, 2^bits - 1)
    ŷ' = ŷ + Δ·q - R

and writes the int32 levels and ŷ'.

What bounds it on an H100: bytes. It reads y, ŷ and u and writes q and ŷ'
once, 5 · 4 B per element: 320 KB at w8a (60 × 267), 0.1 us at 3.35 TB/s,
so at that size a launch costs more than the work. The grid is
``(n, ⌈N / BLOCK⌉)``; each program loads one row tile with a mask for the
ragged tail (the TPU kernel's in-kernel column mask), so nothing is padded.

Both divisions are ``tl.div_rn``: Triton's float32 ``/`` is not correctly
rounded, and an ulp of ``c`` can move a level. With IEEE division the
levels equal the plain version's exactly. The launch turns off floating-
point fusion, so ŷ + Δ·q is rounded twice, as in the plain version, and
not contracted into one FMA.

Triton is imported, and the kernel defined, on first launch: the module
stays importable where Triton is absent.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch

BLOCK = 1024

_kernel = None


def _compile():
    """Define the Triton kernel (once). ``tl`` is bound as a module global
    because a jitted body resolves names in its module's globals."""
    global _kernel, tl
    import triton
    import triton.language as tl

    @triton.jit
    def stoch_quant_kernel(y_ptr, prev_ptr, u_ptr, r_ptr, q_ptr, out_ptr,
                           n_cols, n_levels, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        valid = cols < n_cols
        offs = row.to(tl.int64) * n_cols + cols
        y = tl.load(y_ptr + offs, mask=valid, other=0.0)
        prev = tl.load(prev_ptr + offs, mask=valid, other=0.0)
        u = tl.load(u_ptr + offs, mask=valid, other=0.0)
        R = tl.load(r_ptr + row)
        delta = tl.div_rn(2.0 * R, n_levels)
        safe_delta = tl.where(delta > 0, delta, 1.0)
        c = tl.div_rn(y - prev + R, safe_delta)
        lo = tl.floor(c)
        q = lo + (u < (c - lo)).to(tl.float32)
        q = tl.minimum(tl.maximum(q, 0.0), n_levels)
        tl.store(q_ptr + offs, q.to(tl.int32), mask=valid)
        tl.store(out_ptr + offs, prev + delta * q - R, mask=valid)

    _kernel = stoch_quant_kernel
    return _kernel


def stoch_quant_triton(y: torch.Tensor, y_hat_prev: torch.Tensor,
                       u: torch.Tensor, R: torch.Tensor, *, bits: int):
    """Launch the kernel on CUDA tensors: ``y``, ``y_hat_prev``, ``u`` are
    (n, N) float32, ``R`` is (n,) float32. Returns (levels int32, ŷ')."""
    for name, t in (("y", y), ("y_hat_prev", y_hat_prev), ("u", u), ("R", R)):
        dispatch.check_float32(name, t)
        if t.device.type != "cuda" or t.device != y.device:
            raise ValueError(f"{name} must be on {y.device} (CUDA), got {t.device}")
    if y.dim() != 2 or y_hat_prev.shape != y.shape or u.shape != y.shape:
        raise ValueError("y, y_hat_prev and u must share one (n, N) shape")
    n, N = y.shape
    if tuple(R.shape) != (n,):
        raise ValueError(f"R must be ({n},), got {tuple(R.shape)}")
    if not 1 <= bits <= 24:  # every level exact in float32
        raise ValueError(f"bits must be in [1, 24], got {bits}")
    levels = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    y_hat = torch.empty_like(y)
    if n == 0 or N == 0:
        return levels, y_hat
    kernel = _kernel if _kernel is not None else _compile()
    with torch.cuda.device(y.device):
        kernel[(n, -(-N // BLOCK))](
            y, y_hat_prev, u, R, levels, y_hat, N, float((1 << bits) - 1),
            BLOCK=BLOCK, enable_fp_fusion=False,
        )
    dispatch.count_launch("stoch_quant")
    return levels, y_hat
