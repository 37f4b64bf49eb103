"""FedNew and Q-FedNew (paper Algorithm 1 + Sec. 5), the dense flat path.

Counterpart of ``repro.core.fednew`` with ``hessian_repr="dense"``, full
participation and no diagnostics. State layout mirrors Algorithm 1:

  x      (d,)       global model at the PS (broadcast each round)
  y      (d,)       previous global direction y^{k-1}
  lam    (n, d)     per-client dual variables
  curv   (n, d, d)  per-client curvature cache: the raw H_i on the kernel
                    route (the CG kernel applies the damping itself), the
                    Cholesky factors of H_i + (alpha+rho) I on ``reference``
  comm   (n, w)     per-client codec state (ŷ for stoch_quant, width 0 for
                    the identity codec)
  gen    the explicit ``torch.Generator`` the round's uniforms come from
  step   the round counter, a Python int (no device read to branch on it)

The Hessian refresh rate r of the experiments maps to ``hessian_period``:
r=1 -> 1, r=0.1 -> 10, r=0 -> 0 (the factor from x^0 is kept).

The eq. 9 solve and the eqs. 25-30 quantizer are the two kernels: on the
kernel route (``backend`` ``auto``/``kernel``) a CUDA state launches them
and a CPU state runs their plain versions; ``backend="reference"`` solves
by Cholesky and quantizes with the plain ``core.quantization.quantize``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch.comm import codecs
from repro_torch.core import admm
from repro_torch.core.objectives import ClientDataset, Objective
from repro_torch.core.quantization import exact_payload_bits, word_bits
from repro_torch.device import generator
from repro_torch.kernels import dispatch
from repro_torch.kernels.client_solve.ops import client_solve

CG_ITERS = 32  # fixed CG iterations of the eq. 9 kernel (the TPU default)


@dataclasses.dataclass(frozen=True)
class FedNewConfig:
    rho: float = 1.0
    alpha: float = 1.0
    hessian_period: int = 1  # 0 => never refresh (r = 0)
    bits: Optional[int] = None  # None: FedNew; b: Q-FedNew with b-bit levels
    backend: str = "auto"  # "auto" | "kernel" | "reference" (both hot loops)

    def __post_init__(self):
        dispatch.validate_backend(self.backend)
        if self.hessian_period < 0:
            raise ValueError(
                f"hessian_period must be >= 0, got {self.hessian_period}"
            )
        self.build_codec()  # bad bit widths fail here

    @property
    def damping(self) -> float:
        return self.alpha + self.rho

    @property
    def codec_spec(self) -> Mapping[str, Any]:
        """The uplink codec: ``stoch_quant`` for Q-FedNew, else ``identity``."""
        if self.bits is not None:
            return {"name": "stoch_quant", "bits": self.bits}
        return {"name": "identity"}

    def build_codec(self) -> codecs.Codec:
        return codecs.build_codec(self.codec_spec, backend=self.backend)

    @property
    def solve_uses_kernel(self) -> bool:
        """Whether eq. 9 runs the CG kernel on raw Hessians (else Cholesky)."""
        return dispatch.uses_kernel(self.backend)


class FedNewState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    lam: torch.Tensor  # (n, d) per-client duals
    curv: torch.Tensor  # (n, d, d) raw Hessians or Cholesky factors
    comm: torch.Tensor  # (n, w) per-client codec state
    gen: torch.Generator
    step: int


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    uplink_bits_per_client: torch.Tensor
    dual_sum_residual: torch.Tensor
    direction_norm: torch.Tensor


def _factorize(obj: Objective, x, data, cfg: FedNewConfig) -> torch.Tensor:
    H = obj.local_hessian(x, data)  # (n, d, d)
    if cfg.solve_uses_kernel:
        return H  # the CG kernel applies the (alpha+rho) damping itself
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.linalg.cholesky(H + cfg.damping * eye)


def init(obj: Objective, data: ClientDataset, cfg: FedNewConfig,
         seed: int = 0) -> FedNewState:
    """Round-0 state (x⁰ = 0) on the dataset's device; ``seed`` seeds the
    generator the Q-FedNew uniforms are drawn from."""
    n, d, dev = data.n_clients, data.dim, data.device
    dtype = data.features.dtype
    x = torch.zeros((d,), dtype=dtype, device=dev)
    return FedNewState(
        x=x,
        y=torch.zeros((d,), dtype=dtype, device=dev),
        lam=torch.zeros((n, d), dtype=dtype, device=dev),
        curv=_factorize(obj, x, data, cfg),
        comm=cfg.build_codec().init_state(n, d, dtype, dev),
        gen=generator(dev, seed),
        step=0,
    )


def _local_solve(curv, rhs, cfg: FedNewConfig) -> torch.Tensor:
    """(H_i + (alpha+rho) I)^{-1} rhs, batched over clients (eq. 9)."""
    if cfg.solve_uses_kernel:
        return client_solve(curv, rhs, damping=cfg.damping, iters=CG_ITERS)
    return torch.cholesky_solve(rhs.unsqueeze(-1), curv).squeeze(-1)


def step(state: FedNewState, obj: Objective, data: ClientDataset,
         cfg: FedNewConfig, *, uniforms: Optional[torch.Tensor] = None):
    """One outer round of Algorithm 1 (optionally quantized).

    ``uniforms`` — the round's ``(n, d)`` uniforms for a stochastic codec —
    are drawn from ``state.gen`` when not given; the tests hand in the JAX
    package's, replayed from its key schedule. Returns
    ``(new_state, StepMetrics)`` with every metric a device tensor.
    """
    # -- local Hessian refresh (client-side compute; no communication) ------
    if cfg.hessian_period > 0 and state.step % cfg.hessian_period == 0:
        curv = _factorize(obj, state.x, data, cfg)
    else:
        curv = state.curv

    g_i = obj.local_grad(state.x, data)  # (n, d) — never transmitted

    # -- eq. 9: client sub-problem solve ------------------------------------
    rhs = admm.admm_rhs(g_i, state.lam, state.y.expand_as(g_i), cfg.rho)
    y_i = _local_solve(curv, rhs, cfg)

    # -- uplink compression: encode, and aggregate the PS-side decode -------
    codec = cfg.build_codec()
    if codec.needs_rng and uniforms is None:
        uniforms = torch.rand(y_i.shape, generator=state.gen,
                              dtype=y_i.dtype, device=y_i.device)
    wire = codec.encode(uniforms if codec.needs_rng else None, y_i, state.comm)
    y_i_tx = codec.decode(wire, state.comm)
    comm_state = codec.update_state(y_i_tx, y_i, state.comm)

    # -- eqs. 13 + 12: the ONLY communication + dual update -----------------
    y = admm.tree_mean_clients(y_i_tx)
    lam = admm.dual_update(state.lam, y_i_tx, y.expand_as(y_i_tx), cfg.rho)

    x = state.x - y  # outer Newton step (eq. 14)

    new_state = FedNewState(
        x=x, y=y, lam=lam, curv=curv, comm=comm_state, gen=state.gen,
        step=state.step + 1,
    )
    metrics = StepMetrics(
        loss=obj.global_loss(x, data),
        grad_norm=torch.linalg.norm(obj.global_grad(x, data)),
        uplink_bits_per_client=codec.payload_bits_metric(
            data.dim, word_bits(y_i_tx), x.device
        ),
        dual_sum_residual=admm.dual_sum_residual(lam),
        direction_norm=torch.linalg.norm(y),
    )
    return new_state, metrics


def solver(cfg: FedNewConfig):
    """This algorithm as a ``repro_torch.core.engine.FederatedSolver``."""
    from repro_torch.core import engine

    name = f"q-fednew({cfg.bits}b)" if cfg.bits else "fednew"
    return engine.FederatedSolver(
        name=name,
        init=lambda obj, data, seed=0: init(obj, data, cfg, seed),
        step=lambda state, obj, data: step(state, obj, data, cfg),
        client_fields=("lam", "curv", "comm"),
    )


def ledger(cfg: FedNewConfig):
    """Exact bit accounting: the codec's uplink payload (``word*d`` for
    FedNew, ``bits*d + 32`` for Q-FedNew) and the ``word*d`` broadcast
    iterate down. Refresh rounds cost no extra bits."""
    from repro_torch.core import engine

    codec = cfg.build_codec()
    return engine.SolverLedger(
        uplink=lambda d, word, round_index: codec.payload_bits(
            d, word, round_index
        ),
        downlink=lambda d, word, round_index: exact_payload_bits(d, word),
    )


def run(obj: Objective, data: ClientDataset, cfg: FedNewConfig, rounds: int,
        seed: int = 0):
    """``rounds`` rounds through ``engine.run``'s host loop."""
    from repro_torch.core import engine

    return engine.run(solver(cfg), obj, data, rounds, seed=seed)
