"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code non-zero) on failure:

  1. find the card (no CUDA device -> exit non-zero, nothing else printed)
     and print its name and power limit as nvidia-smi reports them;
  2. build the kernels from the sources in this checkout (nvcc for the
     CUDA C++ kernel, Triton's compiler for the Triton one) and time it;
  3. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes and a few more;
  4. drive the main path — 50 rounds each of FedNew and Q-FedNew(3 bits)
     on w8a-shaped logistic regression (60 clients x 829 samples x 267
     features) through ``engine.get_solver`` / ``engine.run`` — and check
     each run's own launch counts (set to 0 just before it, read just
     after), the optimality gap and the exact bit ledger;
  5. time every kernel, its plain version and its library yardstick with
     CUDA events, and the main path's wall time per round.

The line before the last is ``{"kernels": [...]}``: there ``launches`` is
the kernel's count in the Q-FedNew run, the path that runs every kernel,
and ``launches_by_path`` each run's own count. The last line is
``{"ok": true, "device": {...}}``. Full results go to
``chiprun_out/chip_smoke.json``. ``chip_profile.py`` imports this file's
configuration.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import baselines, engine, objectives  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, dispatch, get_impl  # noqa: E402
from repro_torch.kernels.client_solve.ref import client_solve_ref  # noqa: E402

# Each kernel's wrapper (on CUDA tensors: the kernel) and its plain version,
# from the registry the main path's call sites resolve to.
client_solve = get_impl("client_solve")
client_solve_plain = get_impl("client_solve", "plain")
stoch_quant = get_impl("stoch_quant")
stoch_quant_plain = get_impl("stoch_quant", "plain")

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# The hparams of benchmarks/paper_fig2.py (w8a, r = 1).
MU, RHO, ALPHA, BITS, ROUNDS, SEED = 1e-3, 0.1, 0.03, 3, 50, 42
DAMPING = RHO + ALPHA
# The main path's runs: registry name and the hparams beside RHO/ALPHA.
SOLVERS = (("fednew", {}), ("q-fednew", {"bits": BITS}))
CG_ITERS = 32
EPS32 = float(np.finfo(np.float32).eps)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 60, warmup: int = 5) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call.
    A spin kernel queued ahead of the start event keeps the card busy while
    the host enqueues ``fn``, so host overhead stays out of the reading."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    sync()
    spin_cycles = int(max(2e-4, 3 * enqueue_s) * 2.0e9)
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    sync()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd(gen, n: int, d: int, cond: float = 50.0) -> torch.Tensor:
    """SPD matrices with eigenvalues logspace(0, log10(cond)), as in
    tests/test_kernels.py."""
    Q, _ = torch.linalg.qr(torch.randn((n, d, d), generator=gen,
                                       device="cuda"))
    eigs = torch.logspace(0, math.log10(cond), d, device="cuda")
    return torch.einsum("nij,j,nkj->nik", Q, eigs, Q).contiguous()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    # The reference numbers of this script are full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build()
    nvcc_s = time.perf_counter() - t0
    # Triton compiles on the first launch: one tiny launch builds it.
    t0 = time.perf_counter()
    z = torch.zeros((1, 8), device="cuda")
    stoch_quant(z, z, z, torch.zeros(1, device="cuda"), bits=BITS)
    sync()
    triton_s = time.perf_counter() - t0
    log(f"build: nvcc {nvcc_s:.2f} s ({', '.join(sorted(libs))}), "
        f"triton {triton_s:.2f} s")
    return {"nvcc_s": nvcc_s, "triton_s": triton_s}


def check_client_solve(A, b, label, results, direct_tol=None):
    """Kernel vs plain CG at the main path's 32 iterations (rtol 1e-4 with
    atol 1e-4 max|x|: the same algorithm, sums in another order), and
    optionally vs the direct solve at tests/test_kernels.py's tolerance."""
    got = client_solve(A, b, damping=DAMPING, iters=CG_ITERS)
    plain = client_solve_plain(A, b, damping=DAMPING, iters=CG_ITERS)
    sync()
    err = (got - plain).abs().max().item()
    scale = plain.abs().max().item()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4 * scale)
    ref = client_solve_ref(A, b, damping=DAMPING)
    row = {"shape": list(A.shape), "max_abs_err_vs_plain": err,
           "max_abs_plain": scale,
           "max_abs_err_vs_direct_at_32": (got - ref).abs().max().item()}
    if direct_tol is not None:
        iters, atol, rtol = direct_tol
        got_d = client_solve(A, b, damping=DAMPING, iters=iters)
        sync()
        row["iters_vs_direct"] = iters
        row["max_abs_err_vs_direct"] = (got_d - ref).abs().max().item()
        torch.testing.assert_close(got_d, ref, rtol=rtol, atol=atol)
    log(f"client_solve {label}: {json.dumps(row)}")
    results.append(row)
    return err


def check_stoch_quant(n, N, bits, gen, results):
    """Levels exactly equal to the plain version; ŷ' within 4 ulp of its
    largest magnitude (the kernel may fuse ŷ + Δq into one FMA)."""
    y = torch.randn((n, N), generator=gen, device="cuda")
    prev = torch.randn((n, N), generator=gen, device="cuda")
    prev[0] = y[0]  # an R = 0 row
    u = torch.rand((n, N), generator=gen, device="cuda")
    R = torch.amax(torch.abs(y - prev), dim=-1)
    q, y_hat = stoch_quant(y, prev, u, R, bits=bits)
    q_ref, y_hat_ref = stoch_quant_plain(y, prev, u, R, bits=bits)
    sync()
    mismatches = int((q != q_ref).sum().item())
    err = (y_hat - y_hat_ref).abs().max().item()
    tol = 4 * EPS32 * y_hat_ref.abs().max().item()
    row = {"shape": [n, N], "bits": bits, "level_mismatches": mismatches,
           "max_abs_err": err, "tol": tol}
    log(f"stoch_quant: {json.dumps(row)}")
    results.append(row)
    if mismatches or not err <= tol:
        raise AssertionError(f"stoch_quant disagrees with its plain version: {row}")
    return err


def phase_kernels(obj, data):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {"client_solve": [], "stoch_quant": []}
    # client_solve at the main path's inputs: the raw w8a Hessians and the
    # round-0 right-hand sides (lam = y = 0, so rhs = g_i) at x = 0
    x0 = torch.zeros(data.dim, device="cuda")
    H = obj.local_hessian(x0, data).contiguous()
    g = obj.local_grad(x0, data).contiguous()
    cs_err = check_client_solve(H, g, "w8a", out["client_solve"])
    for d in (40, 99, 263):
        A = spd(gen, 4, d)
        b = torch.randn((4, d), generator=gen, device="cuda")
        check_client_solve(A, b, f"spd d={d}", out["client_solve"],
                           direct_tol=(96, 2e-4, 2e-3))
    sq_err = None
    for N in (data.dim, 4099):
        for bits in (1, 3, 8):
            err = check_stoch_quant(data.n_clients, N, bits, gen,
                                    out["stoch_quant"])
            if N == data.dim and bits == BITS:
                sq_err = err
    sync()
    return out, {"client_solve": cs_err, "stoch_quant": sq_err}, (H, g)


def make_problem():
    """The main path's objective and w8a-shaped data on the card."""
    data = synthetic.make_dataset(synthetic.PAPER_DATASETS["w8a"], SEED,
                                  device="cuda")
    return objectives.logistic_regression(MU), data


def make_solver(name, **hp):
    return engine.get_solver(name, rho=RHO, alpha=ALPHA, hessian_period=1,
                             **hp)


def run_solver(name, obj, data, **hp):
    solver = make_solver(name, **hp)
    sync()
    t0 = time.perf_counter()
    state, m = engine.run(solver, obj, data, ROUNDS, seed=SEED)
    sync()
    return state, m, time.perf_counter() - t0


def phase_main_path(obj, data):
    # f(x*): 30 exact Newton steps, in float64 so the gap is not floored by
    # float32 rounding of f(x*)
    data64 = objectives.ClientDataset(data.features.double(),
                                      data.labels.double())
    _, f_star = baselines.reference_optimum(obj, data64)
    f_star = f_star.item()

    # each run's own launch counts: set to 0 just before it, read just after
    expected = {"fednew": {"client_solve": ROUNDS, "stoch_quant": 0},
                "q-fednew": {"client_solve": ROUNDS, "stoch_quant": ROUNDS}}
    runs, launches = {}, {}
    for name, hp in SOLVERS:
        dispatch.reset_launches()
        runs[name] = run_solver(name, obj, data, **hp)
        launches[name] = dict(dispatch.launches)
        log(f"launches in the {name} run: {launches[name]}")
        if launches[name] != expected[name]:
            raise AssertionError(f"{name} launches {launches[name]}, "
                                 f"expected {expected[name]}")
    st_fn, m_fn, wall_fn = runs["fednew"]
    st_q, m_q, wall_q = runs["q-fednew"]

    for label, m in (("FedNew", m_fn), ("Q-FedNew", m_q)):
        for field in ("loss", "grad_norm", "direction_norm",
                      "dual_sum_residual"):
            v = getattr(m, field)
            if v.shape != (ROUNDS,) or not torch.isfinite(v).all():
                raise AssertionError(f"{label} {field} not finite/(rounds,)")
    bits_fn = m_fn.uplink_bits_per_client.tolist()
    bits_q = m_q.uplink_bits_per_client.tolist()
    if set(bits_fn) != {32 * data.dim} or set(bits_q) != {BITS * data.dim + 32}:
        raise AssertionError(f"bit ledger off: {set(bits_fn)} {set(bits_q)}")

    gap0 = math.log(2.0) - f_star  # f(x^0 = 0) = log 2
    gap_fn = [v - f_star for v in m_fn.loss.double().tolist()]
    gap_q = [v - f_star for v in m_q.loss.double().tolist()]
    last_fn = objectives.logistic_regression(MU).global_loss(
        st_fn.x.double(), data64).item() - f_star
    last_q = objectives.logistic_regression(MU).global_loss(
        st_q.x.double(), data64).item() - f_star
    log(f"gap: f(x*)={f_star!r} start {gap0!r}; FedNew last {last_fn!r} "
        f"(float32 metric {gap_fn[-1]!r}); Q-FedNew last {last_q!r} "
        f"(float32 metric {gap_q[-1]!r})")
    if not last_fn * 1e3 <= gap0:
        raise AssertionError(f"FedNew gap fell only {gap0 / last_fn:.3g}x")

    # the kernel route against the Cholesky route on the same card:
    # same trajectory to solver tolerance (tests/test_dispatch.py:169-171)
    dispatch.reset_launches()
    _, m_ref, _ = run_solver("fednew", obj, data, backend="reference")
    if any(dispatch.launches.values()):
        raise AssertionError(f"reference route launched {dispatch.launches}")
    torch.testing.assert_close(m_fn.loss, m_ref.loss, rtol=1e-4, atol=1e-5)
    log("FedNew kernel route matches the reference (Cholesky) route")

    return {
        "f_star": f_star, "gap0": gap0,
        "fednew": {"gap": gap_fn, "gap_last_f64": last_fn,
                   "uplink_bits_per_client": bits_fn[0],
                   "wall_s": wall_fn, "wall_ms_per_round": wall_fn / ROUNDS * 1e3},
        "q-fednew": {"gap": gap_q, "gap_last_f64": last_q,
                     "uplink_bits_per_client": bits_q[0],
                     "wall_s": wall_q, "wall_ms_per_round": wall_q / ROUNDS * 1e3},
        "launches": launches,
    }


def phase_times(obj, data, H, g):
    n, d = data.n_clients, data.dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)

    cs_ms = device_ms(lambda: client_solve(H, g, damping=DAMPING, iters=CG_ITERS))
    cs_plain = device_ms(lambda: client_solve_plain(H, g, damping=DAMPING,
                                                    iters=CG_ITERS))
    damped = H + DAMPING * torch.eye(d, device="cuda")
    cs_lib = device_ms(lambda: torch.linalg.solve(damped, g))
    cs_bound = bound_ms((n * d * d + 2 * n * d) * 4,
                        CG_ITERS * (2 * n * d * d + 11 * n * d))

    y = torch.randn((n, d), generator=gen, device="cuda")
    prev = torch.randn((n, d), generator=gen, device="cuda")
    u = torch.rand((n, d), generator=gen, device="cuda")
    R = torch.amax(torch.abs(y - prev), dim=-1)
    sq_ms = device_ms(lambda: stoch_quant(y, prev, u, R, bits=BITS))
    sq_plain = device_ms(lambda: stoch_quant_plain(y, prev, u, R, bits=BITS))
    sq_bound = bound_ms((5 * n * d + n) * 4, 12 * n * d)

    # wall time per round, host clock around whole synchronized runs
    walls = {}
    for name, hp in SOLVERS:
        per_round = []
        for _ in range(3):
            per_round.append(run_solver(name, obj, data, **hp)[2] / ROUNDS * 1e3)
        walls[name] = {"ms_per_round_runs": per_round,
                       "ms_per_round_median": statistics.median(per_round)}
    times = {
        "client_solve": {"ms": cs_ms, "plain_ms": cs_plain,
                         "library_ms": cs_lib, "bound_ms": cs_bound[0],
                         "bound_by": cs_bound[1]},
        "stoch_quant": {"ms": sq_ms, "plain_ms": sq_plain, "library_ms": None,
                        "bound_ms": sq_bound[0], "bound_by": sq_bound[1]},
        "wall_ms_per_round": walls,
    }
    for k, v in times.items():
        log(json.dumps({"time": k, **v}))
    return times


def main() -> int:
    smi = phase_device()
    build = phase_build()

    obj, data = make_problem()

    checks, errs, (H, g) = phase_kernels(obj, data)
    main_path = phase_main_path(obj, data)
    times = phase_times(obj, data, H, g)

    kernels = []
    for name in dispatch.registered_kernels():
        info = dispatch.kernel_info(name)
        kernels.append({
            "name": name, "route": info["route"], "source": info["source"],
            "replaces": info["replaces"],
            "launches": main_path["launches"]["q-fednew"][name],
            "launches_by_path": {path: counts[name] for path, counts
                                 in main_path["launches"].items()},
            "max_abs_err": errs[name],
            **{k: times[name][k] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "device": device, "build": build,
                   "checks": checks, "main_path": main_path, "times": times,
                   "kernels": kernels, "torch": torch.__version__,
                   "cuda": torch.version.cuda}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
