"""The port's kernel modules against the JAX package, on the CPU.

On the CPU every port wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions (the kernels' twins) against the JAX
Pallas kernels in interpret mode and against the JAX references. The
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_parity import np32, spd, t
from repro.core import quantization as jax_quant
from repro.kernels.client_solve.client_solve import client_solve_cg
from repro.kernels.client_solve.ref import client_solve_ref as jax_solve_ref
from repro.kernels.stoch_quant.ref import stoch_quant_ref as jax_sq_ref
from repro.kernels.stoch_quant.stoch_quant import stoch_quant as jax_sq_kernel
from repro_torch.core import quantization
from repro_torch.kernels import dispatch, get_impl, registered_kernels
from repro_torch.kernels.client_solve import ops as cs_ops
from repro_torch.kernels.client_solve.ref import client_solve_plain, client_solve_ref
from repro_torch.kernels.stoch_quant import ops as sq_ops
from repro_torch.kernels.stoch_quant.ref import stoch_quant_ref
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention.ref import swa_attention_plain

DAMPING = 0.13  # alpha + rho of the w8a runs
EPS32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# client_solve
# ---------------------------------------------------------------------------


def _system(d, n=4):
    rng = np.random.default_rng(d)
    return spd(rng, n, d), np32(rng.standard_normal((n, d)))


@pytest.mark.parametrize("d", [40, 99, 263])
def test_client_solve_plain_matches_pallas_cg(d):
    """The port's plain CG is the kernel's twin; the JAX kernel runs the same
    32 guarded CG steps (interpret mode, unpadded). Tolerance rtol 1e-4:
    the same algorithm with f32 sums taken in another order."""
    A, b = _system(d)
    got = client_solve_plain(t(A), t(b), damping=DAMPING, iters=32)
    want = client_solve_cg(A, b, damping=DAMPING, iters=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("d", [40, 99, 263])
def test_client_solve_ref_matches_jax_ref(d):
    """Both direct solves (LU) in f32: rtol 1e-4 covers the two LAPACK
    paths' rounding at condition number ~50."""
    A, b = _system(d)
    got = client_solve_ref(t(A), t(b), damping=DAMPING)
    want = jax_solve_ref(A, b, damping=DAMPING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_client_solve_wrapper_routes_cpu_to_plain():
    """A CPU tensor takes the plain CG and launches nothing."""
    A, b = _system(40)
    dispatch.reset_launches()
    got = cs_ops.client_solve(t(A), t(b), damping=DAMPING)
    want = client_solve_plain(t(A), t(b), damping=DAMPING)
    assert torch.equal(got, want)
    assert dispatch.launches == {name: 0 for name in registered_kernels()}


def test_client_solve_plain_converges_to_direct_solve():
    """Enough CG iterations reach the direct solve (the kernel's contract,
    at tests/test_kernels.py's tolerance)."""
    A, b = _system(99)
    got = client_solve_plain(t(A), t(b), damping=DAMPING, iters=96)
    want = client_solve_ref(t(A), t(b), damping=DAMPING)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("bad", ["shape", "rhs", "device"])
def test_client_solve_wrapper_rejects_bad_input(bad):
    A, b = (t(x) for x in _system(8, n=2))
    if bad == "shape":
        A = A[:, :, :4]
    elif bad == "rhs":
        b = b[:, :4]
    else:  # neither CPU nor CUDA: no kernel and no plain route
        A, b = A.to("meta"), b.to("meta")
    with pytest.raises(ValueError):
        cs_ops.client_solve(A, b, damping=DAMPING)


# ---------------------------------------------------------------------------
# stoch_quant
# ---------------------------------------------------------------------------


def _quant_inputs(n, N, seed=0):
    rng = np.random.default_rng(seed)
    y = np32(rng.standard_normal((n, N)))
    prev = np32(rng.standard_normal((n, N)))
    prev[0] = y[0]  # an R = 0 row: the guarded Δ
    u = np32(rng.random((n, N)))
    R = np32(np.max(np.abs(y - prev), axis=1))
    return y, prev, u, R


@pytest.mark.parametrize("N", [267, 1027])
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_stoch_quant_plain_matches_jax_ref(N, bits):
    """Levels EQUAL to JAX's reference and its Pallas kernel (interpret);
    ŷ' within 4 ulp of its largest magnitude."""
    y, prev, u, R = _quant_inputs(5, N, seed=N + bits)
    q, y_hat = stoch_quant_ref(t(y), t(prev), t(u), t(R), bits=bits)
    q_ref, y_hat_ref = jax_sq_ref(y, prev, u, R, bits=bits)
    q_pal, _ = jax_sq_kernel(y, prev, u, R, bits=bits, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_pal))
    assert not q.numpy()[0].any()  # R = 0: c = 0, so level 0
    tol = 4 * EPS32 * np.abs(np.asarray(y_hat_ref)).max()
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(y_hat_ref), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_quantize_matches_jax_quantize_given_its_uniforms(bits):
    """The reference route: the port's plain quantizer fed the uniforms JAX
    draws from its keys gives JAX's levels exactly."""
    n, N = 6, 99
    rng = np.random.default_rng(bits)
    y = np32(rng.standard_normal((n, N)))
    prev = np32(rng.standard_normal((n, N)))
    keys = jax.random.split(jax.random.PRNGKey(bits), n)
    u = np.stack([np.asarray(jax.random.uniform(k, (N,))) for k in keys])
    want = jax_quant.quantize_with_keys(keys, y, prev, bits)
    got = quantization.quantize(t(u), t(y), t(prev), bits)
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(want.levels))
    np.testing.assert_allclose(got.y_hat.numpy(), np.asarray(want.y_hat),
                               rtol=0, atol=4 * EPS32 * np.abs(want.y_hat).max())
    assert got.payload_bits.tolist() == [bits * N + 32] * n


def test_quantize_with_uniforms_equals_reference_route():
    """The kernel route's wrapper and the reference quantizer agree on the
    levels (same formula, same uniforms), and the wrapper's ranges give the
    reference's step size bit for bit."""
    y, prev, u, _ = _quant_inputs(7, 300, seed=3)
    levels, R = sq_ops.quantize_with_uniforms(t(u), t(y), t(prev), 3)
    b = quantization.quantize(t(u), t(y), t(prev), 3)
    assert torch.equal(levels, b.levels)
    torch.testing.assert_close(quantization.step_size(R, 3), b.delta,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# swa_attention (its plain version against JAX: tests/test_torch_attention.py)
# ---------------------------------------------------------------------------


def test_swa_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (chip_smoke.py runs the
    same check at gemma3-4b's full shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the swa_attention kernel has no CPU route")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        rng = np.random.default_rng(3)
        q, k, v = (torch.from_numpy(np32(rng.standard_normal((2, 200, h, 64))))
                   .to("cuda", dtype) for h in (4, 2, 2))
        got = swa_ops.swa_attention(q, k, v, window=64, cap=20.0)
        want = swa_attention_plain(q, k, v, window=64, cap=20.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_registry_pairs_each_kernel_with_its_plain_version():
    assert registered_kernels() == ("client_solve", "stoch_quant", "swa_attention")
    for name in registered_kernels():
        info = dispatch.kernel_info(name)
        assert info["route"] in ("cuda", "triton")
        assert callable(get_impl(name, "kernel"))
        assert callable(get_impl(name, "plain"))
    y, prev, u, R = _quant_inputs(3, 50)
    args = (t(y), t(prev), t(u), t(R))
    for got, want in zip(get_impl("stoch_quant")(*args, bits=3),
                         get_impl("stoch_quant", "plain")(*args, bits=3)):
        assert torch.equal(got, want)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        dispatch.validate_backend("pallas")
    assert dispatch.uses_kernel("auto") and dispatch.uses_kernel("kernel")
    assert not dispatch.uses_kernel("reference")
