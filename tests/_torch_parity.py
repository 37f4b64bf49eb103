"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are built with numpy or with the JAX package, handed to both sides
as numpy arrays, and compared with the named tolerances below. Everything
runs float32 on the CPU; JAX's x64 mode is never toggled (it would leak
into other test files sharing a worker).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.objectives import logistic_regression as jax_logreg
from repro.data.synthetic import DatasetSpec, make_dataset
from repro_torch import convert
from repro_torch.core.objectives import logistic_regression as torch_logreg

# Whole f32 trajectories through CG or Cholesky in two frameworks: the
# tolerances of tests/test_dispatch.py:169-171.
TRAJ = dict(rtol=1e-4, atol=1e-5)
# One f32 oracle evaluation: the same expression, sums in another order.
ORACLE = dict(rtol=2e-5, atol=1e-6)

MU = 1e-3
RHO, ALPHA = 0.1, 0.03  # benchmarks/paper_fig2.py


def np32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True))


def tree_t(tree):
    """A nested dict of numpy / JAX arrays -> the same dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: tree_t(v) for k, v in tree.items()}
    return t(tree)


def small_problem(n=4, m=32, d=20, seed=0):
    """A small w8a-like problem built by the JAX package: (jax objective,
    jax data, port objective, port data on the CPU)."""
    spec = DatasetSpec("parity", n_clients=n, samples_per_client=m, dim=d,
                       sparse=True)
    jdata = make_dataset(spec, jax.random.PRNGKey(seed))
    tdata = convert.dataset_from_numpy(
        np.asarray(jdata.features), np.asarray(jdata.labels), device="cpu"
    )
    return jax_logreg(MU), jdata, torch_logreg(MU), tdata


def spd(rng: np.random.Generator, n: int, d: int, cond: float = 50.0):
    """SPD matrices with eigenvalues logspace(0, log10(cond)), as
    tests/test_kernels.py builds them, from numpy."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, d, d)))
    eigs = np.logspace(0.0, np.log10(cond), d)
    return np32(np.einsum("nij,j,nkj->nik", Q, eigs, Q))


def replay_uniforms(key, n: int, d: int):
    """One Q-FedNew round's uniforms as ``repro.core.fednew.step`` draws
    them from its state key: ``(next_key, (n, d) uniforms)``."""
    from repro import comm

    key, sub = jax.random.split(key)
    keys = comm.client_keys(sub, n, None, None)
    u = jnp.stack([jax.random.uniform(k, (d,), jnp.float32) for k in keys])
    return key, np.asarray(u)
