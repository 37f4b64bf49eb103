"""Where the time goes on the card: ``torch.profiler`` traces of the
port's paths with the configuration, data and model of ``chip_smoke.py``:
FedNew and Q-FedNew(3 bits) rounds at w8a width, and gemma3-4b serving at
full width and depth (batch 4, 4096-token prompt): one prefill, then
DECODE_TOKENS greedy decode steps.

    python3 chip_profile.py

Prints, per run, the wall time, the device's busy time (the union of
kernel intervals on the card), its idle share, and the device time by
kernel name (for serving also by kind: the swa_attention kernel, bf16
GEMMs, float32 GEMMs, the rest); writes the Chrome traces and the same
numbers under ``chiprun_out/``. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

# chip_smoke puts src/ on the import path
from chip_smoke import (GEN, PROMPT, ROOT, SEED, SOLVERS, greedy,
                        make_problem, make_serving, make_solver, phase_device)
from repro_torch.core import engine
from repro_torch.models import lm

PROFILE_ROUNDS = 20
DECODE_TOKENS = 4


def busy_us(events) -> float:
    """Length of the union of the device kernels' intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def traced(name, fn, out_dir):
    """Profile one call of ``fn``: (device kernel events, wall µs)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError(f"the profiler recorded no device time for {name}")
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return kernels, wall_us


def by_name_us(kernels):
    out = {}
    for e in kernels:
        out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def profile(name, obj, data, out_dir, **hp):
    solver = make_solver(name, **hp)
    engine.run(solver, obj, data, 3, seed=SEED)  # warm-up: builds, caches
    torch.cuda.synchronize()
    kernels, wall_us = traced(
        name, lambda: engine.run(solver, obj, data, PROFILE_ROUNDS, seed=SEED),
        out_dir)
    busy = busy_us(kernels)
    top = sorted(by_name_us(kernels).items(), key=lambda kv: -kv[1])[:12]
    rounds = PROFILE_ROUNDS
    row = {
        "solver": name, "rounds": rounds,
        "wall_ms_per_round": wall_us / rounds / 1e3,
        "device_busy_ms_per_round": busy / rounds / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels_per_round": len(kernels) / rounds,
        "top_kernels_us_per_round": [[k, v / rounds] for k, v in top],
    }
    print(json.dumps(row), flush=True)
    return row


def kernel_kind(name: str) -> str:
    """The swa_attention kernel, a library matrix product in float32 on the
    CUDA cores (cuBLAS/CUTLASS names with f32, sgemm, simt or <float>: the
    global layers' attention and decode's score products), any other
    library matrix product (the bf16 projections), or the rest."""
    low = name.lower()
    if "swa_attention" in low:
        return "swa_attention"
    if any(w in low for w in ("gemm", "gemv", "xmma", "nvjet", "cutlass")):
        if any(w in low for w in ("f32", "sgemm", "simt", "<float")):
            return "gemm_f32"
        return "gemm_bf16"
    return "other"


def serving_row(run, kernels, wall_us, per):
    """Device time by kind and by name, divided by ``per`` (steps)."""
    names = by_name_us(kernels)
    kinds = {}
    for k, v in names.items():
        kinds[kernel_kind(k)] = kinds.get(kernel_kind(k), 0.0) + v
    busy = busy_us(kernels)
    row = {
        "run": run, "per": per, "wall_ms": wall_us / per / 1e3,
        "device_busy_ms": busy / per / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels": len(kernels) / per,
        "device_ms_by_kind": {k: v / per / 1e3 for k, v in sorted(kinds.items())},
        "top_kernels_ms": [[k, v / per / 1e3] for k, v in
                           sorted(names.items(), key=lambda kv: -kv[1])[:15]],
    }
    print(json.dumps(row), flush=True)
    return row


def profile_serving(out_dir):
    """One gemma3-4b prefill at full width and depth after a warm-up, then
    DECODE_TOKENS decode steps on its caches."""
    with torch.inference_mode():
        cfg, params, toks = make_serving()
        prompt = {"tokens": toks[:, :PROMPT].contiguous()}
        B = prompt["tokens"].shape[0]
        state = {}

        def prefill():
            state["logits"], state["caches"] = lm.prefill(
                params, cfg, prompt, max_len=PROMPT + GEN)

        def decode():
            tok = greedy(state["logits"])
            for i in range(DECODE_TOKENS):
                pos = torch.full((B,), PROMPT + i, dtype=torch.int32,
                                 device=tok.device)
                logits, _ = lm.decode_step(params, cfg, tok[:, None], pos,
                                           state["caches"])
                tok = greedy(logits)

        prefill()
        decode()  # warm-up of both
        torch.cuda.synchronize()
        rows = [serving_row("serve-prefill",
                            *traced("serve-prefill", prefill, out_dir), 1)]
        rows.append(serving_row("serve-decode",
                                *traced("serve-decode", decode, out_dir),
                                DECODE_TOKENS))
    return rows


def main() -> int:
    smi = phase_device()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    obj, data = make_problem()
    rows = [profile(name, obj, data, out_dir, **hp) for name, hp in SOLVERS]
    rows += profile_serving(out_dir)
    with open(os.path.join(out_dir, "chip_profile.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
