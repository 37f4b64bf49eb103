"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code non-zero) on failure:

  1. find the card (no CUDA device -> exit non-zero, nothing else printed)
     and print its name and power limit as nvidia-smi reports them;
  2. build the kernels from the sources in this checkout (one nvcc per
     CUDA C++ source, all started together; Triton's compiler for the
     Triton one) and time it;
  3. hold every kernel against its plain PyTorch version on the card, at
     the main paths' shapes and a few more;
  4. drive the FedNew path — 50 rounds each of FedNew and Q-FedNew(3 bits)
     on w8a-shaped logistic regression (60 clients x 829 samples x 267
     features) through ``engine.get_solver`` / ``engine.run`` — and check
     each run's own launch counts (set to 0 just before it, read just
     after), the optimality gap and the exact bit ledger;
  5. drive the serving path — gemma3-4b at its published widths and all 34
     layers, random weights from a seed, batch 4, a 4096-token prompt and
     16 greedy tokens through ``launch.serve.serve``, then its prefill and
     its decode steps alone (``models.lm``) — and check finite logits, the
     launch counts of each (29 swa_attention launches per prefill, one per
     local layer; none per decode token), and decode against the full
     forward;
  6. time every kernel, its plain version and its library yardstick with
     CUDA events, the FedNew path's wall time per round, and the serving
     path's prefill and decode times.

The line before the last is ``{"kernels": [...]}``: there ``launches`` is
the kernel's count on the path that runs it (Q-FedNew for the FedNew
kernels, the prefill for swa_attention) and ``launches_by_path`` every
path's own count. The last line is ``{"ok": true, "device": {...}}``. Full
results go to ``chiprun_out/chip_smoke.json``. ``chip_profile.py`` imports
this file's configuration.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import baselines, engine, objectives  # noqa: E402
from repro_torch.data import synthetic, tokens  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import _build, dispatch, get_impl  # noqa: E402
from repro_torch.kernels.client_solve.ref import client_solve_ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import attention, lm, transformer  # noqa: E402

# Each kernel's wrapper (on CUDA tensors: the kernel) and its plain version,
# from the registry the main path's call sites resolve to.
client_solve = get_impl("client_solve")
client_solve_plain = get_impl("client_solve", "plain")
stoch_quant = get_impl("stoch_quant")
stoch_quant_plain = get_impl("stoch_quant", "plain")
swa_attention = get_impl("swa_attention")
swa_attention_plain = get_impl("swa_attention", "plain")

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 rate
# outside the tensor cores, dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# The hparams of benchmarks/paper_fig2.py (w8a, r = 1).
MU, RHO, ALPHA, BITS, ROUNDS, SEED = 1e-3, 0.1, 0.03, 3, 50, 42
DAMPING = RHO + ALPHA
# The main path's runs: registry name and the hparams beside RHO/ALPHA.
SOLVERS = (("fednew", {}), ("q-fednew", {"bits": BITS}))
CG_ITERS = 32
EPS32 = float(np.finfo(np.float32).eps)

# The serving path: gemma3-4b at its published widths and depth.
ARCH = "gemma3-4b"
SERVE_BATCH, PROMPT, GEN = 4, 4096, 16
# decode-vs-forward reference: the backbone over PROMPT + REF_EXTRA tokens (a
# multiple of the 1024-token attention chunk), read at position PROMPT
REF_EXTRA = 1024
# decode is timed over this many windows of GEN - 1 steps (median kept)
DECODE_WINDOWS = 5
# the f32 gate runs one pattern repeat (5 local + 1 global layers)
GATE_LAYERS = 6
# f32 decode vs full forward at full width: the same arithmetic, sums in
# another order over d = 2560..10240; an indexing or cache fault is O(1)
GATE_F32_RTOL = 1e-3
# The swa_attention checks: (label, B, S, H, Hkv, window, dtype, cap,
# q_scale); Dh 256. Each case runs in float32 (held at 1e-5) and in bf16.
# With q scaled by 8 the scores are ~N(0, 64), so cap 50 (gemma2's value)
# moves them by O(1); at q_scale 1 it would move them by ~1e-3.
SWA_CASES = tuple(
    (f"{label} {tag}", B, S, H, Hkv, 1024, dtype, cap, q_scale)
    for label, B, S, H, Hkv, cap, q_scale in (
        ("main", 4, PROMPT, 8, 4, None, 1.0),
        ("cap 50, q x8", 4, PROMPT, 8, 4, 50.0, 8.0),
        ("ragged S=1000", 4, 1000, 8, 4, None, 1.0),
        ("G=1", 4, PROMPT, 8, 8, None, 1.0),
    )
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)))
# bf16 check, per element: one bf16 ulp of the plain output plus this
# (float32 sums in another order before the one final rounding)
SWA_BF16_ATOL = 1e-5
HEAD_DIM = 256
# where each kernel's `launches` is read: a path that runs it
KERNEL_PATH = {"client_solve": "q-fednew", "stoch_quant": "q-fednew",
               "swa_attention": "serve-prefill"}
PATHS = ("fednew", "q-fednew", "serve-prefill", "serve-decode")


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


def bound_ms(n_bytes: float, n_flops: float, flops_per_s=FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
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
    # The reference numbers of this script are full float32, and bf16
    # products are reduced in float32 (cuBLAS may otherwise reduce in bf16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    none = {name: 0 for name in dispatch.registered_kernels()}
    expected = {"fednew": {**none, "client_solve": ROUNDS},
                "q-fednew": {**none, "client_solve": ROUNDS,
                             "stoch_quant": ROUNDS}}
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


def swa_inputs(gen, B, S, H, Hkv, dtype, q_scale=1.0):
    """Random q (B,S,H,Dh), k and v (B,S,Hkv,Dh) on the card."""
    q, k, v = [torch.randn((B, S, h, HEAD_DIM), generator=gen, device="cuda")
               for h in (H, Hkv, Hkv)]
    return [x.to(dtype) for x in (q * q_scale, k, v)]


def bf16_ulp(x):
    """One bf16 ulp of each element of x (0 where x is 0)."""
    mant, exp = torch.frexp(x.float())
    return torch.where(mant == 0, 0.0, torch.ldexp(torch.ones_like(mant),
                                                   exp - 8))


def swa_excess(got, want):
    """max over elements of |got - want| / tol, where tol is rtol = atol =
    1e-5 in float32 (the same arithmetic, sums in another order) and, in
    bf16, one bf16 ulp of want plus SWA_BF16_ATOL (both sides widen to
    float32 and accumulate there; only the final rounding differs). The
    check passes at <= 1."""
    g, w = got.float(), want.float()
    if want.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * w.abs()
    else:
        tol = bf16_ulp(w) + SWA_BF16_ATOL
    return ((g - w).abs() / tol).max().item()


def phase_swa_checks():
    """swa_attention vs its plain version, element by element (swa_excess).
    In the capped cases the uncapped plain output must fail the same check,
    so a kernel that skipped the cap could not pass."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    rows, main_err = [], None
    for label, B, S, H, Hkv, window, dtype, cap, q_scale in SWA_CASES:
        q, k, v = swa_inputs(gen, B, S, H, Hkv, dtype, q_scale)
        got = swa_attention(q, k, v, window=window, cap=cap)
        want = swa_attention_plain(q, k, v, window=window, cap=cap)
        sync()
        err = (got.float() - want.float()).abs().max().item()
        row = {"case": label, "shape": [B, S, H, Hkv, HEAD_DIM],
               "window": window, "cap": cap, "q_scale": q_scale,
               "dtype": str(dtype), "max_abs_err": err,
               "max_abs_plain": want.float().abs().max().item(),
               "err_over_tol": swa_excess(got, want)}
        if cap is not None:
            row["uncapped_err_over_tol"] = swa_excess(
                swa_attention_plain(q, k, v, window=window), want)
        log(f"swa_attention {label}: {json.dumps(row)}")
        rows.append(row)
        if not row["err_over_tol"] <= 1.0:
            raise AssertionError(f"swa_attention disagrees with its plain "
                                 f"version: {row}")
        if cap is not None and not row["uncapped_err_over_tol"] > 1.0:
            raise AssertionError(f"the capped check cannot tell the cap: {row}")
        if main_err is None:
            main_err = err
    return rows, main_err


def make_serving(device="cuda"):
    """gemma3-4b at full width and depth with seeded random weights, and
    the token batch (B, PROMPT + REF_EXTRA) whose first PROMPT tokens are
    the prompt."""
    cfg = get_config(ARCH)
    params = lm.init_params(cfg, generator(torch.device(device), SEED), device)
    batch = tokens.make_batch(
        cfg, InputShape("serve", PROMPT + REF_EXTRA, SERVE_BATCH, "prefill"),
        SEED, device=device)
    return cfg, params, batch["tokens"]


def finite(name, x):
    if not torch.isfinite(x).all():
        raise AssertionError(f"{name}: non-finite values")


def counted(path, expected, counts, fn):
    """Run ``fn`` with every launch count set to 0 just before it, record
    the counts just after under ``path``, and check them."""
    dispatch.reset_launches()
    out = fn()
    sync()
    counts[path] = dict(dispatch.launches)
    want = {name: 0 for name in dispatch.registered_kernels()}
    want.update(expected)
    if counts[path] != want:
        raise AssertionError(f"{path} launches {counts[path]}, expected {want}")
    return out


def greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def decode_vs_forward(cfg, params, toks):
    """Prefill PROMPT tokens, decode token PROMPT; the reference is the
    backbone over all PROMPT + REF_EXTRA tokens read at index PROMPT.
    Returns max |Δlogit| / max |logit|."""
    _, caches = lm.prefill(params, cfg, {"tokens": toks[:, :PROMPT]},
                           max_len=PROMPT + 1)
    pos = torch.full((toks.shape[0],), PROMPT, dtype=torch.int32,
                     device=toks.device)
    got, _ = lm.decode_step(params, cfg, toks[:, PROMPT:PROMPT + 1], pos, caches)
    feats, _ = lm.backbone(params, cfg, {"tokens": toks})
    ref = lm.logits_fn(params, cfg, feats[:, PROMPT:PROMPT + 1])
    finite("decode logits", got)
    finite("forward logits", ref)
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def phase_serve(cfg, params, toks, counts):
    """The serving path at full width and depth: ``serve`` once, then its
    prefill and decode steps alone, each with its own launch counts."""
    B = toks.shape[0]
    prompt = toks[:, :PROMPT].contiguous()
    n_local = transformer.layer_kinds(cfg).count("local")
    kinds = {"local": n_local, "global": cfg.n_layers - n_local}
    log(f"serving {cfg.name}: d {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, window {cfg.window}, layers {kinds}, "
        f"params {sum(p.numel() for p in _leaves(params)):,}; batch {B}, "
        f"prompt {PROMPT}, gen {GEN}")

    t0 = time.perf_counter()
    ids = counted("serve", {"swa_attention": n_local}, counts,
                  lambda: serve(cfg, params, prompt, GEN))
    serve_s = time.perf_counter() - t0
    if ids.shape != (B, GEN):
        raise AssertionError(f"serve returned {tuple(ids.shape)}")

    # the same path in its two parts: prefill (timed), then decode steps
    prefill_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits, caches = counted(
            "serve-prefill", {"swa_attention": n_local}, counts,
            lambda: lm.prefill(params, cfg, {"tokens": prompt},
                               max_len=PROMPT + GEN))
        prefill_s.append(time.perf_counter() - t0)
        finite("prefill logits", logits)

    def decode_all(out, ok):  # no host read inside: checked after
        for i in range(GEN - 1):
            pos = torch.full((B,), PROMPT + i, dtype=torch.int32,
                             device=toks.device)
            step_logits, _ = lm.decode_step(params, cfg, out[-1][:, None],
                                            pos, caches)
            ok.append(torch.isfinite(step_logits).all())
            out.append(greedy(step_logits))

    # decode is host-bound and its host time varies, so it is timed over
    # DECODE_WINDOWS windows of GEN - 1 steps. Every window starts from the
    # prefill's caches, restored (outside the timing) before it starts.
    prefilled = [t.clone() for t in _leaves(caches)]
    decode_s = []
    for _ in range(DECODE_WINDOWS):
        for t, saved in zip(_leaves(caches), prefilled):
            t.copy_(saved)
        out, ok = [greedy(logits)], []
        t0 = time.perf_counter()
        counted("serve-decode", {}, counts, lambda: decode_all(out, ok))
        decode_s.append(time.perf_counter() - t0)
        if not torch.stack(ok).all():
            raise AssertionError("decode logits: non-finite values")
        steps_ids = torch.stack(out, dim=1).cpu()
        if not torch.equal(steps_ids, ids):
            raise AssertionError("serve's ids differ from its prefill + "
                                 "decode steps run alone")
    log(f"launches: {json.dumps({p: counts[p] for p in ('serve', 'serve-prefill', 'serve-decode')})}")
    log(f"generated ids (row 0): {ids[0].tolist()}")

    # decode against the full forward: gated in float32 at one pattern
    # repeat (5 local + 1 global layers), reported in bf16 at full depth
    cfg_f32 = dataclasses.replace(cfg, n_layers=GATE_LAYERS,
                                  activation_dtype="float32")
    params_f32 = dict(params, blocks=params["blocks"][:GATE_LAYERS])
    rel_f32 = decode_vs_forward(cfg_f32, params_f32, toks)
    rel_bf16 = decode_vs_forward(cfg, params, toks)
    log(f"decode vs forward at position {PROMPT}: float32 {GATE_LAYERS} "
        f"layers {rel_f32!r} (gate {GATE_F32_RTOL}), bf16 {cfg.n_layers} "
        f"layers {rel_bf16!r} (finiteness gated)")
    if not rel_f32 <= GATE_F32_RTOL:
        raise AssertionError(f"decode disagrees with the forward: {rel_f32}")

    n_decoded = GEN - 1
    matmul = torch.backends.cuda.matmul
    return {
        "arch": cfg.name, "batch": B, "prompt": PROMPT, "gen": GEN,
        "precision": {  # as phase_device set them
            "matmul.allow_tf32": matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul.allow_bf16_reduced_precision_reduction":
                matmul.allow_bf16_reduced_precision_reduction},
        "ids_row0": ids[0].tolist(), "serve_wall_s_first_call": serve_s,
        "prefill_s_runs": prefill_s,
        "prefill_ms_median": statistics.median(prefill_s) * 1e3,
        "decode_ms_per_token_runs": [t / n_decoded * 1e3 for t in decode_s],
        "decode_ms_per_token": statistics.median(decode_s) / n_decoded * 1e3,
        "decode_tokens_per_s": B * n_decoded / statistics.median(decode_s),
        "decode_vs_forward_rel": {"float32_6_layers": rel_f32,
                                  "bf16_full_depth": rel_bf16},
        "swa_launches_per_prefill": counts["serve-prefill"]["swa_attention"],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def swa_bound(B, S, H, Hkv, window, dtype):
    """Least time for the band: 4 B H Dh sum_q min(q+1, window) operations
    at the bf16 tensor-core peak, or q, k, v and out moved once."""
    keys = sum(min(i + 1, window) for i in range(S))
    n_flops = 4 * B * H * HEAD_DIM * keys
    elt = torch.tensor([], dtype=dtype).element_size()
    n_bytes = elt * B * S * HEAD_DIM * (2 * H + 2 * Hkv)
    return bound_ms(n_bytes, n_flops, BF16_FLOPS_PER_S)


def phase_serve_times(cfg, serving):
    """The kernel at the prefill's shape beside its bound, its plain version
    and the SDPA yardstick; a global layer's plain attention; the kernel's
    share of prefill."""
    _, B, S, H, Hkv, window, dtype, _, _ = SWA_CASES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    q, k, v = swa_inputs(gen, B, S, H, Hkv, dtype)
    ms = device_ms(lambda: swa_attention(q, k, v, window=window), reps=20)
    plain = device_ms(lambda: swa_attention_plain(q, k, v, window=window),
                      reps=5, warmup=1)
    # yardstick: one SDPA call with an explicit sliding-window mask, kv
    # repeated to H heads, heads-major layout (prepared outside the timing)
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(H // Hkv, dim=2),
                   v.repeat_interleave(H // Hkv, dim=2)))
    lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           attn_mask=mask),
                    reps=10)
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
               .transpose(1, 2).float()
               - swa_attention(q, k, v, window=window).float()).abs().max().item()
    bound = swa_bound(B, S, H, Hkv, window, dtype)
    glob = device_ms(lambda: attention.causal_attention(q, k, v, cfg, window=None,
                                                        cap=None),
                     reps=5, warmup=1)
    n_local = serving["swa_launches_per_prefill"]
    n_global = cfg.n_layers - n_local
    prefill_ms = serving["prefill_ms_median"]
    times = {
        "swa_attention": {"ms": ms, "plain_ms": plain, "library_ms": lib,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "library_max_abs_diff": lib_err},
        "global_attention_ms": glob,
        "prefill_ms": prefill_ms,
        "kernel_share_of_prefill": n_local * ms / prefill_ms,
        "global_attention_share_of_prefill": n_global * glob / prefill_ms,
        "decode_ms_per_token": serving["decode_ms_per_token"],
        "decode_ms_per_token_runs": serving["decode_ms_per_token_runs"],
        "decode_tokens_per_s": serving["decode_tokens_per_s"],
    }
    for key, val in times.items():
        log(json.dumps({"time": key, "value": val}))
    return times


def main() -> int:
    smi = phase_device()
    build = phase_build()

    obj, data = make_problem()

    checks, errs, (H, g) = phase_kernels(obj, data)
    checks["swa_attention"], errs["swa_attention"] = phase_swa_checks()
    main_path = phase_main_path(obj, data)
    times = phase_times(obj, data, H, g)

    counts = dict(main_path["launches"])
    with torch.inference_mode():
        cfg, params, toks = make_serving()
        serving = phase_serve(cfg, params, toks, counts)
        del params
        times.update(phase_serve_times(cfg, serving))

    kernels = []
    for name in dispatch.registered_kernels():
        info = dispatch.kernel_info(name)
        kernels.append({
            "name": name, "route": info["route"], "source": info["source"],
            "replaces": info["replaces"],
            "launches": counts[KERNEL_PATH[name]][name],
            "launches_by_path": {path: counts[path][name] for path in PATHS},
            "max_abs_err": errs[name],
            **{k: times[name][k] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "device": device, "build": build,
                   "checks": checks, "main_path": main_path,
                   "serving": serving, "launches": counts, "times": times,
                   "kernels": kernels, "torch": torch.__version__,
                   "cuda": torch.version.cuda}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
