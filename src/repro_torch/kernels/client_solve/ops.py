"""Wrapper of the client_solve CUDA kernel (``csrc/client_solve.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor runs
the plain CG of ``ref.py``. Unlike the TPU wrapper there is no padding: the
kernel takes any d whose four CG vectors fit in shared memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.client_solve.ref import client_solve_plain

# x, r, p and Ap in shared memory: 4 d floats within a block's 227 KB
MAX_DIM = (232_448 - 1024) // 16


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("client_solve")
    fn = lib.client_solve_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # A, b, x
        ctypes.c_int, ctypes.c_int,  # n, d
        ctypes.c_float, ctypes.c_int,  # damping, iters
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    lib.client_solve_error_string.argtypes = [ctypes.c_int]
    lib.client_solve_error_string.restype = ctypes.c_char_p
    return lib


def client_solve(A: torch.Tensor, b: torch.Tensor, *, damping: float,
                 iters: int = 32) -> torch.Tensor:
    """(n, d) solutions of (A_i + damping I) x = b_i, ``A`` the raw
    (undamped) Hessians (n, d, d) and ``b`` the (n, d) right-hand sides."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (n, d, d), got {tuple(A.shape)}")
    n, d, _ = A.shape
    if tuple(b.shape) != (n, d):
        raise ValueError(f"b must be ({n}, {d}), got {tuple(b.shape)}")
    if b.device != A.device:
        raise ValueError(f"A on {A.device} but b on {b.device}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not dispatch.kernel_route(A, "client_solve"):
        return client_solve_plain(A, b, damping=damping, iters=iters)
    dispatch.check_float32("A", A)
    dispatch.check_float32("b", b)
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"client_solve kernel takes 1 <= d <= {MAX_DIM}, got {d}")
    x = torch.empty_like(b)
    if n == 0:
        return x
    lib = _library()
    with torch.cuda.device(A.device):
        err = lib.client_solve_launch(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), n, d, float(damping),
            iters, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "client_solve kernel launch failed: "
            + lib.client_solve_error_string(err).decode()
        )
    dispatch.count_launch("client_solve")
    return x
