"""Rules the port keeps as a package: it imports neither JAX nor the JAX
package, its entry points default to the CUDA card and never fall back to
the CPU, and its kernels build only from this checkout's sources."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic, tokens
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import lm

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_profile.py",
]


def _forbidden_imports(path: Path, root: Path = REPO):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                yield f"{path.relative_to(root)}:{node.lineno}: {name}"


def test_port_imports_no_jax_and_no_repro():
    assert len(PORT_FILES) > 10
    found = [hit for p in PORT_FILES for hit in _forbidden_imports(p)]
    assert not found, found


def test_import_guard_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import fednew\n"
                   "from repro_torch.core import fednew as ok\n")
    hits = list(_forbidden_imports(bad, tmp_path))
    assert [h.split(": ")[1] for h in hits] == ["jax.numpy", "repro.core"]


def test_entry_points_default_to_cuda():
    """Left at its default the device is the card: without one the entry
    points raise instead of running on the CPU."""
    feats, labels = np.zeros((2, 3, 4), np.float32), np.ones((2, 3), np.float32)
    spec = synthetic.DatasetSpec("tiny", 2, 3, 4, sparse=False)
    if torch.cuda.is_available():
        assert convert.dataset_from_numpy(feats, labels).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.dataset_from_numpy(feats, labels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.make_dataset(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.uniforms_from_numpy(np.zeros((2, 4), np.float32))
    assert synthetic.make_dataset(spec, device="cpu").features.shape == (2, 3, 4)

    cfg = get_config("gemma3-4b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tokens.make_batch(cfg, InputShape("s", 8, 2, "prefill"), 0)
    params = lm.init_params(cfg, torch.Generator(), "cpu")
    tree = {"embed": {"table": np.zeros((4, 2), np.float32)},
            "blocks": {"scan": [{}, {}], "tail": []},
            "final_norm": {"scale": np.zeros(2, np.float32)}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(tree, cfg)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-4b", "--reduced", "--gen", "2"],
        cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                       "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    # the serving loop itself runs where its tensors lie
    prompt = tokens.make_batch(cfg, InputShape("s", 8, 2, "prefill"), 0,
                               device="cpu")["tokens"]
    with torch.inference_mode():
        assert serve.serve(cfg, params, prompt, 2).shape == (2, 2)


def test_make_dataset_is_seeded_and_shaped():
    spec = synthetic.PAPER_DATASETS["a1a"]
    a = synthetic.make_dataset(spec, 3, device="cpu")
    b = synthetic.make_dataset(spec, 3, device="cpu")
    c = synthetic.make_dataset(spec, 4, device="cpu")
    assert a.features.shape == (10, 160, 99) and a.labels.shape == (10, 160)
    assert torch.equal(a.features, b.features) and torch.equal(a.labels, b.labels)
    assert not torch.equal(a.features, c.features)
    assert set(a.labels.unique().tolist()) == {-1.0, 1.0}
    zeros = (a.features == 0).float().mean().item()
    assert 0.8 < zeros < 0.9  # ~85% zeros, like the a/w LibSVM files


def test_kernel_sources_build_from_the_checkout():
    """Every CUDA source is found in the package's csrc/, and its library
    goes to the ignored build directory, named by the source's hash."""
    assert _build.sources() == ("client_solve", "swa_attention")
    path = _build._library_path("client_solve")
    assert path.parent == REPO / "build" / "repro_torch_kernels"
    assert path.name.startswith("client_solve-") and path.suffix == ".so"
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler: the build raises, naming what is missing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["client_solve"])


def test_build_reuses_a_library_of_the_same_source(monkeypatch, tmp_path):
    """A library named by the source's hash is not built again."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    libs = {name: _build._library_path(name) for name in _build.sources()}
    for lib in libs.values():
        lib.write_bytes(b"")
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("rebuilt"))
    assert _build.build() == libs


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    card, and in a directory that holds it and nothing else of the repo."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
