"""Where a round's time goes on the card: a ``torch.profiler`` trace of the
port's main path, FedNew and Q-FedNew(3 bits) at w8a width, with the
configuration, data and solvers of ``chip_smoke.py``.

    python3 chip_profile.py

Prints, per solver, the wall time of the profiled rounds, the device's busy
time (the union of kernel intervals on the card), its idle share, and the
device time by kernel name; writes the Chrome traces and the same numbers
under ``chiprun_out/``. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

# chip_smoke puts src/ on the import path
from chip_smoke import ROOT, SEED, SOLVERS, make_problem, make_solver, phase_device
from repro_torch.core import engine

PROFILE_ROUNDS = 20


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


def profile(name, obj, data, out_dir, **hp):
    solver = make_solver(name, **hp)
    engine.run(solver, obj, data, 3, seed=SEED)  # warm-up: builds, caches
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run(solver, obj, data, PROFILE_ROUNDS, seed=SEED)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError(f"the profiler recorded no device time for {name}")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = busy_us(kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    rounds = PROFILE_ROUNDS
    row = {
        "solver": name, "rounds": rounds,
        "wall_ms_per_round": wall_us / rounds / 1e3,
        "device_busy_ms_per_round": busy / rounds / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernels_per_round": len(kernels) / rounds,
        "top_kernels_us_per_round": [[k, v / rounds] for k, v in top],
    }
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    smi = phase_device()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    obj, data = make_problem()
    rows = [profile(name, obj, data, out_dir, **hp) for name, hp in SOLVERS]
    with open(os.path.join(out_dir, "chip_profile.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
