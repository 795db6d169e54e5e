"""Import hygiene of the port and its no-fallback rule.

The port imports ``torch`` and never ``jax`` or anything of the JAX
package; only its tests import both.  A missing CUDA toolkit, or tensors
on two devices, make the kernel entry points raise instead of quietly
taking a plain path.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, embedding_bag, qr_gather, serve_path

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_files_import_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_serving_stack_import_leaves_jax_out():
    code = ("import sys, repro_torch.serve.recsys, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.configs.dlrm_criteo, repro_torch.data.criteo, "
            "repro_torch.kernels.qr_gather, repro_torch.kernels.embedding_bag; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_missing_toolkit_or_mixed_devices_raise(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    cpu = torch.zeros((2, 2))
    meta = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        _build.launch_device(cpu, meta)
    ids = torch.zeros((2, 1), dtype=torch.int32)
    wrappers = [
        lambda: serve_path.fused_serve_pool(ids, torch.ones((2, 1)), meta),
        lambda: qr_gather.qr_gather(ids[:, 0], ids[:, 0], meta, cpu),
        lambda: qr_gather.qr_gather_quant(ids[:, 0], ids[:, 0], meta.to(torch.int8),
                                          cpu.to(torch.int8), None, None, None, None),
        lambda: embedding_bag.qr_embedding_bag(ids, ids, torch.ones((2, 1)), cpu, meta),
    ]
    for call in wrappers:
        with pytest.raises(ValueError, match="one CUDA device"):
            call()
    assert _build.launch_device(cpu, None) is None


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: unsupported gpu architecture' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert set(_build.SOURCES) == {"serve_path", "dot_interaction", "qr_gather",
                                   "embedding_bag"}
    with pytest.raises(RuntimeError, match="(?s)build failed.*unsupported gpu") as err:
        _build.build_all(_build.SOURCES)
    for name in _build.SOURCES:
        assert f"{name} (nvcc exit 2)" in str(err.value)
    assert not list((tmp_path / "build").iterdir())
