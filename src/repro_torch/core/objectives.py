"""Client objectives for the flat FedNew path.

Counterpart of ``repro.core.objectives`` (the dense ``(d,)`` layout only).
The paper evaluates regularized logistic regression (eqs. 31-32):

    f(x) = (1/n) sum_i f_i(x),
    f_i(x) = (1/m) sum_j log(1 + exp(-b_ij a_ij^T x)) + (mu/2) ||x||^2

with the regularizer folded into every client's loss so the global
objective is the mean of the local ones. Per-client quantities carry a
leading client axis ``n``; the batch over clients is written out as tensor
ops where JAX used ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ClientDataset:
    """Per-client data: features (n, m, d), labels (n, m) in {-1, +1}."""

    features: torch.Tensor
    labels: torch.Tensor

    @property
    def n_clients(self) -> int:
        return self.features.shape[0]

    @property
    def dim(self) -> int:
        return self.features.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.features.device


@dataclasses.dataclass(frozen=True)
class Objective:
    """Per-client oracles, each over the whole client axis:

    local_loss(x, data)    -> (n,)
    local_grad(x, data)    -> (n, d)
    local_hessian(x, data) -> (n, d, d)
    """

    local_loss: Callable
    local_grad: Callable
    local_hessian: Callable

    def global_loss(self, x, data: ClientDataset) -> torch.Tensor:
        return torch.mean(self.local_loss(x, data), dim=0)

    def global_grad(self, x, data: ClientDataset) -> torch.Tensor:
        return torch.mean(self.local_grad(x, data), dim=0)

    def global_hessian(self, x, data: ClientDataset) -> torch.Tensor:
        return torch.mean(self.local_hessian(x, data), dim=0)


def _margins(x, data: ClientDataset) -> torch.Tensor:
    """z_ij = b_ij a_ij^T x, shape (n, m)."""
    return data.labels * torch.matmul(data.features, x)


def logistic_regression(mu: float = 1e-3) -> Objective:
    def loss(x, data):
        z = _margins(x, data)
        # log(1 + exp(-z)) computed stably
        nll = torch.mean(torch.logaddexp(torch.zeros_like(z), -z), dim=-1)
        return nll + 0.5 * mu * torch.dot(x, x)

    def grad(x, data):
        z = _margins(x, data)
        w = -torch.sigmoid(-z) * data.labels  # d/dz log(1+e^{-z}) · b
        m = data.features.shape[1]
        g = torch.matmul(data.features.transpose(-1, -2), w.unsqueeze(-1))
        return g.squeeze(-1) / m + mu * x

    def hessian(x, data):
        s = torch.sigmoid(_margins(x, data))
        w = s * (1.0 - s)  # (n, m); b^2 == 1
        A = data.features
        H = torch.matmul(A.transpose(-1, -2) * w.unsqueeze(-2), A) / A.shape[1]
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return H + mu * eye

    return Objective(local_loss=loss, local_grad=grad, local_hessian=hessian)
