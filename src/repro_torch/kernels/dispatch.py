"""Routing for the port's kernels.

Counterpart of ``repro.kernels.dispatch``. The route is decided by where the
tensors lie, never by an environment variable and never by whether a
kernel builds:

  CUDA tensor  the hand-written Hopper kernel is launched; if it cannot be
               built or launched, the call raises.
  CPU tensor   the kernel's plain PyTorch version runs (the tests' route).

Each kernel's ``ops.py`` wrapper makes that choice with
:func:`kernel_route`; ``core.fednew``, ``comm.codecs`` and
``models.attention`` call the wrappers.

Config-level backends (``FedNewConfig.backend``):

  ``auto``       the kernel route — what the TPU build runs on its chip.
  ``kernel``     the same, named explicitly.
  ``reference``  no kernel: eq. 9 by batched Cholesky and the plain
                 quantizer of ``core.quantization`` (JAX's ``reference``).

Every kernel wrapper adds one to ``launches[name]`` where it launches its
kernel and nowhere else, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

import torch

BACKENDS = ("auto", "kernel", "reference")

# name -> number of kernel launches since the last reset_launches()
launches: Dict[str, int] = {}

# name -> {"kernel": "module:attr", "plain": "module:attr", ...metadata}
_REGISTRY: Dict[str, Dict[str, str]] = {}


def validate_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}"
        )
    return backend


def uses_kernel(backend: str) -> bool:
    """True when a config-level backend takes the kernel route."""
    return validate_backend(backend) != "reference"


def register_kernel(name: str, **entry: str) -> None:
    """Register a kernel: ``kernel=`` its wrapper, ``plain=`` its plain
    PyTorch version, plus descriptive metadata (``route``, ``source``,
    ``replaces``) that reports read."""
    _REGISTRY[name] = dict(entry)
    launches.setdefault(name, 0)


def registered_kernels() -> tuple:
    return tuple(sorted(_REGISTRY))


def kernel_info(name: str) -> Dict[str, str]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; have {registered_kernels()}")
    return dict(_REGISTRY[name])


def _load(path: str) -> Callable:
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def get_impl(name: str, flavor: str = "kernel") -> Callable:
    """The registered ``kernel`` wrapper or ``plain`` version of ``name``."""
    return _load(kernel_info(name)[flavor])


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def kernel_route(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(
        f"{name}: no kernel and no plain route for device {t.device}"
    )


def check_float32(name: str, t: torch.Tensor) -> None:
    """Input check shared by the kernel wrappers."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
