"""Carry-over from the JAX package: its arrays, as numpy, into the port's
objects on a given device (the CUDA card unless another is named).

The tests build datasets, states and LM params with the JAX package, pass
them through numpy, and continue or compare in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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


def _tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_to(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, *,
                         device: DeviceLike = None) -> dict:
    """``jax.tree.map(np.asarray, repro.models.lm.init_params(cfg, key))``
    -> the port's LM params. JAX stacks each pattern position's layers over
    the repeats (``blocks.scan[p][leaf][r]``) and keeps the remainder in
    ``blocks.tail[t]``; the port's ``blocks`` is one list in layer order:
    repeat r, position p is layer ``r * len(pattern) + p``, then the tail."""
    dev = resolve_device(device)
    scan, tail = tree["blocks"]["scan"], tree["blocks"]["tail"]
    if len(scan) != len(cfg.layer_pattern) or len(tail) != cfg.tail_len:
        raise ValueError(f"params do not match {cfg.name}'s layer pattern")
    blocks = [_tree_to(scan[p], lambda a, r=r: _tensor(a[r], dev))
              for r in range(cfg.pattern_repeats)
              for p in range(len(cfg.layer_pattern))]
    blocks += [_tree_to(t, lambda a: _tensor(a, dev)) for t in tail]
    rest = {k: v for k, v in tree.items() if k != "blocks"}
    return {"blocks": blocks, **_tree_to(rest, lambda a: _tensor(a, dev))}
