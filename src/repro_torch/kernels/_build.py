"""Build and load the port's CUDA C++ kernels.

Every ``csrc/<name>.cu`` exposes a plain C entry point. On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the repository root, named by the hash
of its source so an edited kernel is rebuilt, and loaded with ``ctypes``.
No PyTorch header is compiled, so a build takes seconds, not minutes.

``--use_fast_math`` is deliberately absent: the kernels' divisions and
reductions must keep IEEE float32 semantics to hold against their plain
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> tuple:
    """Names of the CUDA sources (``csrc/<name>.cu``)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor in /usr/local/cuda/bin); "
            "the CUDA kernels cannot be built"
        )
    return nvcc


def _library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = ()) -> Dict[str, Path]:
    """Compile the named sources (all by default) that have no library yet,
    one ``nvcc`` process per source, all started together. Raises with the
    compiler's output if any build fails."""
    names = tuple(names) or sources()
    out = {n: _library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return _libs[name]
