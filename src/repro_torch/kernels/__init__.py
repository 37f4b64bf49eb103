"""Hand-written Hopper kernels of the port, one per Pallas TPU kernel
ported so far.

  client_solve   CUDA C++ (``csrc/client_solve.cu``): fixed-iteration CG for
                 FedNew's eq. 9 damped SPD solve, one block per client
  stoch_quant    Triton (``stoch_quant/stoch_quant.py``): Q-FedNew's
                 eqs. 25-30 stochastic quantizer over a (clients, blocks) grid
  swa_attention  CUDA C++ (``csrc/swa_attention.cu``): causal sliding-window
                 attention forward of the LM's local layers, one block per
                 (batch, head, 64 queries)

Each kernel package pairs the kernel with a plain PyTorch version
(``ref.py``) and a wrapper (``ops.py``) that routes by the tensor's device
(``dispatch.kernel_route``). Entries are module-path strings resolved on
use, so importing this package imports no kernel toolchain.
"""

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import (  # noqa: F401  (public re-exports)
    get_impl,
    kernel_info,
    launches,
    register_kernel,
    registered_kernels,
    reset_launches,
)

dispatch.register_kernel(
    "client_solve",
    kernel="repro_torch.kernels.client_solve.ops:client_solve",
    plain="repro_torch.kernels.client_solve.ref:client_solve_plain",
    route="cuda",
    source="src/repro_torch/kernels/csrc/client_solve.cu",
    replaces="src/repro/kernels/client_solve/client_solve.py:68",
)
dispatch.register_kernel(
    "stoch_quant",
    kernel="repro_torch.kernels.stoch_quant.ops:stoch_quant",
    plain="repro_torch.kernels.stoch_quant.ref:stoch_quant_ref",
    route="triton",
    source="src/repro_torch/kernels/stoch_quant/stoch_quant.py",
    replaces="src/repro/kernels/stoch_quant/stoch_quant.py:80",
)
dispatch.register_kernel(
    "swa_attention",
    kernel="repro_torch.kernels.swa_attention.ops:swa_attention",
    plain="repro_torch.kernels.swa_attention.ref:swa_attention_plain",
    route="cuda",
    source="src/repro_torch/kernels/csrc/swa_attention.cu",
    replaces="src/repro/kernels/swa_attention/swa_attention.py:101",
)
