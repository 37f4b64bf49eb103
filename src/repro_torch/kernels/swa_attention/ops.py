"""Wrapper of the swa_attention CUDA kernel (``csrc/swa_attention.cu``).

``swa_attention(q, k, v, window=..., cap=...)`` takes the model layout,
q (B, S, H, Dh) and k/v (B, S, Hkv, Dh), and returns (B, S, H, Dh) in q's
dtype. A CUDA tensor launches the kernel on the current stream; a CPU
tensor runs the plain band recurrence of ``ref.py``. Unlike the TPU
wrapper there is no transpose around the kernel (it reads the model layout
through strides) and no ``S % q_blk`` requirement (it masks the ragged
edge itself).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.swa_attention.ref import swa_attention_plain

MAX_HEAD_DIM = 256  # the kernel's accumulator: 8 columns of 32 lanes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("swa_attention")
    fn = lib.swa_attention_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,  # dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,  # B, S, H, Hkv, Dh, window
        ctypes.c_float, ctypes.c_float, ctypes.c_int,  # scale, cap, has_cap
        ctypes.POINTER(ctypes.c_int64),  # 12 strides
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    lib.swa_attention_error_string.argtypes = [ctypes.c_int]
    lib.swa_attention_error_string.restype = ctypes.c_char_p
    return lib


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, cap: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention: query s attends keys
    ``(s - window, s]`` of kv head ``h // (H // Hkv)``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,S,H,Dh), k and v (B,S,Hkv,Dh) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, Dh):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not dispatch.kernel_route(q, "swa_attention"):
        return swa_attention_plain(q, k, v, window=window, cap=cap)
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"swa_attention kernel takes float32 or bfloat16 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (Dh % 4 == 0 and 4 <= Dh <= MAX_HEAD_DIM):
        raise ValueError(f"swa_attention kernel takes Dh % 4 == 0 and "
                         f"Dh <= {MAX_HEAD_DIM}, got {Dh}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out)
                                      for s in x.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.swa_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, H, Hkv, Dh, window, Dh ** -0.5,
            0.0 if cap is None else float(cap), int(cap is not None),
            strides, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("swa_attention kernel launch failed: "
                           + lib.swa_attention_error_string(err).decode())
    dispatch.count_launch("swa_attention")
    return out
