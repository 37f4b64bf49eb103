"""Deterministic synthetic token batches (port of ``repro.data.tokens``).

The same numpy stream as the JAX package, so a seed gives the same tokens
in both: a per-row ``x_{t+1} = (a x_t + b + noise) % V`` chain. Batches are
built on the host and moved to the requested device (the CUDA card unless
another is named). The modality stubs (patch and frame embeddings) and the
per-client splits are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def _markov_tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Cheap structured stream: tokens follow x_{t+1} = (a x_t + b + noise) % V
    per row. Returns the stream plus each row's multiplier ``a`` (the row's
    "document topic")."""
    a = rng.integers(2, 7, size=(batch, 1))
    b = rng.integers(0, vocab, size=(batch, 1))
    x = np.empty((batch, seq + 1), np.int64)
    x[:, 0] = rng.integers(0, vocab, size=batch)
    noise = rng.integers(0, 3, size=(batch, seq))
    for t in range(seq):
        x[:, t + 1] = (a[:, 0] * x[:, t] + b[:, 0] + noise[:, t]) % vocab
    return x, a[:, 0] - 2


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int, step: int = 0,
               *, device: DeviceLike = None) -> dict:
    """tokens and targets (B, S) int32, loss_mask (B, S) float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B = shape.global_batch
    S = shape.seq_len
    stream, _ = _markov_tokens(rng, B, S, cfg.vocab_size)
    stream = torch.from_numpy(stream.astype(np.int32))
    return {
        "tokens": stream[:, :-1].contiguous().to(dev),
        "targets": stream[:, 1:].contiguous().to(dev),
        "loss_mask": torch.ones((B, S), dtype=torch.float32, device=dev),
    }
