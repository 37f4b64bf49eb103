"""Synthetic datasets with the geometry of the paper's LibSVM tasks.

The port's own copy of ``repro.data.synthetic`` (``DatasetSpec``,
``PAPER_DATASETS``, ``make_dataset``): the same Table-1 shapes and the same
construction — sparse-ish binary-dominated features around client-specific
anchors, spread column scales, labels from a ground-truth linear model with
logistic noise. The draws come from an explicit ``torch.Generator`` seeded
with ``seed``, so the bits differ from the JAX package's; the parity tests
build their data with the JAX package and hand it over through numpy.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.objectives import ClientDataset
from repro_torch.device import DeviceLike, generator, resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_clients: int  # n
    samples_per_client: int  # m
    dim: int  # d
    sparse: bool  # LibSVM a/w files are ~binary sparse
    heterogeneity: float = 1.0  # scale of per-client anchor shift
    separation: float = 2.0  # ||w_true|| scale: curvature drift x^0 -> x*
    noise: float = 0.5  # logistic label-noise temperature
    col_spread: float = 0.7  # log10 spread of feature scales (conditioning)


# Shapes straight from Table 1 of the paper.
PAPER_DATASETS = {
    "a1a": DatasetSpec("a1a", n_clients=10, samples_per_client=160, dim=99, sparse=True),
    "w7a": DatasetSpec("w7a", n_clients=80, samples_per_client=308, dim=263, sparse=True),
    "w8a": DatasetSpec("w8a", n_clients=60, samples_per_client=829, dim=267, sparse=True),
    "phishing": DatasetSpec("phishing", n_clients=40, samples_per_client=276, dim=40, sparse=False),
}


def make_dataset(spec: DatasetSpec, seed: int = 0, *, device: DeviceLike = None,
                 dtype=torch.float32) -> ClientDataset:
    """The dataset of ``spec``, drawn on ``device`` (the CUDA card unless
    another is named) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    n, m, d = spec.n_clients, spec.samples_per_client, spec.dim
    kw = dict(generator=gen, device=dev, dtype=dtype)

    anchors = spec.heterogeneity * torch.randn((n, 1, d), **kw) / math.sqrt(d)
    feats = torch.randn((n, m, d), **kw) / math.sqrt(d) + anchors
    if spec.sparse:
        # ~85% zeros with binary-ish magnitudes, like the adult/web features.
        keep = torch.rand((n, m, d), **kw) < 0.15
        feats = torch.where(keep, torch.sign(feats) * (torch.abs(feats) + 0.5),
                            torch.zeros_like(feats))
    # Spread per-feature scales (ill-conditioning) and separate the classes
    # enough that curvature at x* differs from curvature at x^0.
    scales = torch.logspace(0.0, spec.col_spread, d, device=dev, dtype=dtype)
    feats = feats * scales
    w_true = spec.separation * torch.randn((d,), **kw) / scales
    logits = torch.matmul(feats, w_true)
    # standard logistic noise by inversion of a uniform draw
    u = torch.rand((n, m), **kw).clamp(min=1e-7, max=1 - 1e-7)
    noise = (torch.log(u) - torch.log1p(-u)) * spec.noise
    labels = torch.where(logits + noise > 0, 1.0, -1.0).to(dtype)
    return ClientDataset(features=feats, labels=labels)
