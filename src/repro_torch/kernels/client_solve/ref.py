"""Plain PyTorch versions of the client_solve kernel.

``client_solve_plain`` is the kernel's twin: the same fixed-iteration CG
with the same guarded denominators, in tensor ops. ``client_solve_ref`` is
the direct solve, the counterpart of ``repro.kernels.client_solve.ref``.
"""

from __future__ import annotations

import torch


def client_solve_plain(A: torch.Tensor, b: torch.Tensor, *, damping: float,
                       iters: int = 32) -> torch.Tensor:
    """(n,d,d), (n,d) -> (A_i + damping I)^{-1} b_i by ``iters`` CG steps."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=-1)
    zero = torch.zeros_like(rs)
    for _ in range(iters):
        ap = torch.matmul(A, p.unsqueeze(-1)).squeeze(-1) + damping * p
        denom = torch.sum(p * ap, dim=-1)
        alpha = torch.where(denom > 0, rs / torch.clamp(denom, min=1e-30), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = torch.sum(r * r, dim=-1)
        beta = torch.where(rs > 0, rs_new / torch.clamp(rs, min=1e-30), zero)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def client_solve_ref(A: torch.Tensor, b: torch.Tensor, *,
                     damping: float) -> torch.Tensor:
    """(n,d,d), (n,d) -> the exact (A_i + damping I)^{-1} b_i (LU)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A + damping * eye, b)
