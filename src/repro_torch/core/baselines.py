"""Exact Newton, the reference that defines f(x*).

Counterpart of ``repro.core.baselines``' ``newton_init``/``newton_step``
and ``reference_optimum``: the paper's f(x*) is the 30th iterate of exact
(centralized) Newton.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.objectives import ClientDataset, Objective


class SimpleState(NamedTuple):
    x: torch.Tensor
    step: int


def newton_init(obj: Objective, data: ClientDataset) -> SimpleState:
    x = torch.zeros((data.dim,), dtype=data.features.dtype, device=data.device)
    return SimpleState(x=x, step=0)


def newton_step(state: SimpleState, obj: Objective,
                data: ClientDataset) -> SimpleState:
    g = obj.global_grad(state.x, data)
    H = obj.global_hessian(state.x, data)
    x = state.x - torch.linalg.solve(H, g)
    return SimpleState(x=x, step=state.step + 1)


def reference_optimum(obj: Objective, data: ClientDataset, iters: int = 30):
    """(x*, f(x*)) as the paper defines them: the ``iters``-th iterate of
    exact Newton from x = 0."""
    state = newton_init(obj, data)
    for _ in range(iters):
        state = newton_step(state, obj, data)
    return state.x, obj.global_loss(state.x, data)
