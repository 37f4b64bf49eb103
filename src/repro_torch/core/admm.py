"""One-pass consensus ADMM pieces shared by FedNew's flat path.

Counterpart of ``repro.core.admm`` (full participation, flat tensors):

    y_i  = (H_i + (alpha+rho) I)^{-1} (g_i - lam_i + rho y)   (eq. 9)
    y    = mean_i y_i                                         (eq. 13)
    lam_i += rho (y_i - y)                                    (eq. 12)
"""

from __future__ import annotations

import torch


def tree_mean_clients(v: torch.Tensor) -> torch.Tensor:
    """mean_i y_i: the only cross-client communication in FedNew (eq. 13)."""
    return torch.mean(v, dim=0)


def dual_update(lam, y_i, y, rho: float) -> torch.Tensor:
    """lam_i += rho (y_i - y) (eq. 12); preserves sum_i lam_i = 0."""
    return lam + rho * (y_i - y)


def admm_rhs(g_i, lam, y_prev, rho: float) -> torch.Tensor:
    """Right-hand side of the client sub-problem solve (eq. 9)."""
    return g_i - lam + rho * y_prev


def dual_sum_residual(lam: torch.Tensor) -> torch.Tensor:
    """|| sum_i lam_i ||, the invariant behind eq. 13; stays ~0."""
    part = torch.sum(lam, dim=0)
    return torch.sqrt(torch.sum(part**2))
