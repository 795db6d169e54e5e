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

from repro_torch.kernels import _build, dot_interaction, embedding_bag, qr_gather, ref, serve_path

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
            "repro_torch.kernels.qr_gather, repro_torch.kernels.embedding_bag, "
            "repro_torch.train.loop, repro_torch.optim.optimizers, "
            "repro_torch.ckpt.checkpoint, repro_torch.models.dcn, "
            "repro_torch.configs.dcn_criteo, repro_torch.data.loader, "
            "repro_torch.benchmarks.run, repro_torch.benchmarks.paper_tables, "
            "repro_torch.benchmarks.kernels_bench, repro_torch.examples.quickstart, "
            "repro_torch.examples.train_dlrm_criteo, repro_torch.serve.cache, "
            "repro_torch.benchmarks.serve_bench, repro_torch.benchmarks.serve_soak, "
            "repro_torch.obs, repro_torch.online, repro_torch.benchmarks.drift_bench, "
            "repro_torch.dist, repro_torch.dist.world, repro_torch.launch.train, "
            "repro_torch.benchmarks.dist_bench, repro_torch.examples.compression_sweep, "
            "repro_torch.dist.sharding, repro_torch.dist.serve_placement, "
            "repro_torch.benchmarks.serve_dist_bench, repro_torch.analysis, "
            "repro_torch.analysis.cli, repro_torch.analysis.acc_audit, "
            "repro_torch.analysis.wire_audit, repro_torch.analysis.jit_audit, "
            "repro_torch.analysis.injectivity; "
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
        lambda: embedding_bag.qr_embedding_bag_raw(ids, torch.ones((2, 1)), meta, cpu),
        lambda: serve_path.fused_serve_pool_grouped(ids[:, :, None], None,
                                                    [ref.GroupTable(meta)]),
        lambda: qr_gather.qr_gather_quant_grouped(ids, [ref.GroupTable(
            meta.to(torch.int8), cpu.to(torch.int8), m=2)]),
        lambda: qr_gather.qr_gather_grouped(ids, [ref.GroupTable(meta, cpu, m=2)]),
        lambda: dot_interaction.dot_interaction_concat(cpu, meta[:, None]),
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
    assert set(_build.SOURCES) == {"grouped_lookup", "dot_interaction"}
    with pytest.raises(RuntimeError, match="(?s)build failed.*unsupported gpu") as err:
        _build.build_all(_build.SOURCES)
    for name in _build.SOURCES:
        assert f"{name} (nvcc exit 2)" in str(err.value)
    assert not list((tmp_path / "build").iterdir())
