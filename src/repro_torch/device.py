"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Asking for CUDA (explicitly or by default) on a machine
    without a card raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """An explicit, seeded generator on ``device`` (the port's stand-in for
    a ``jax.random`` key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
