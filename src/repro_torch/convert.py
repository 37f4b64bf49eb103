"""Carry-over from the JAX package: its arrays, as numpy, into the port's
objects on a given device (the CUDA card unless another is named).

The tests build datasets and states with the JAX package, pass them
through numpy, and continue or compare in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fednew import FedNewState
from repro_torch.core.objectives import ClientDataset
from repro_torch.device import DeviceLike, generator, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def dataset_from_numpy(features, labels, *,
                       device: DeviceLike = None) -> ClientDataset:
    """features (n, m, d) and labels (n, m) -> ``ClientDataset``."""
    dev = resolve_device(device)
    return ClientDataset(features=_tensor(features, dev),
                         labels=_tensor(labels, dev))


def fednew_state_from_numpy(x, y, lam, curv, comm, step: int, *,
                            seed: int = 0,
                            device: DeviceLike = None) -> FedNewState:
    """The fields of a ``repro.core.fednew.FedNewState`` -> the port's state.
    ``curv`` must be in the layout of the port's route (raw Hessians on the
    kernel route, Cholesky factors on ``reference``), as it is in a JAX state
    of the matching route. The JAX key has no counterpart: the port's
    generator is seeded with ``seed``."""
    dev = resolve_device(device)
    return FedNewState(
        x=_tensor(x, dev), y=_tensor(y, dev), lam=_tensor(lam, dev),
        curv=_tensor(curv, dev), comm=_tensor(comm, dev),
        gen=generator(dev, seed), step=int(step),
    )


def uniforms_from_numpy(u, *, device: DeviceLike = None) -> torch.Tensor:
    """One round's (n, d) uniforms."""
    return _tensor(u, resolve_device(device))
