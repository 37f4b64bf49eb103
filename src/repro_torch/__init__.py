"""PyTorch/H100 port of the FedNew system (``repro``).

The JAX package ``repro`` stays the reference; this package re-implements
its main path — FedNew and Q-FedNew (paper Algorithm 1) on regularized
logistic regression — in PyTorch, with the two hot loops as hand-written
Hopper kernels (``repro_torch.kernels``): the eq. 9 client solve in CUDA C++
and the eqs. 25-30 stochastic quantizer in Triton.

Entry points take an explicit ``device``. Left unset it is the CUDA card,
and a machine without one raises instead of running on the CPU; the CPU
runs only when asked for (``device="cpu"``), and then every kernel wrapper
takes its plain PyTorch version.
"""
