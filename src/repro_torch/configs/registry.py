"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures whose path the port serves are registered; the
others of the JAX package's registry raise ``KeyError`` until their
modules are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ("gemma3-4b",)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.CONFIG
