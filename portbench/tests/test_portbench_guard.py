"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names compare by the
whole top-level name: ``repro_torch`` begins with ``repro`` and is not it."""

import ast

import pytest
from conftest import REPO

from portbench.lib import guard

HARNESS = REPO / "portbench"
MODULES = sorted(p for p in HARNESS.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & {"repro_torch", "repro"}
    assert "repro_torch" not in path.read_text()


def test_guard_compares_whole_top_level_names():
    loaded = {"repro_torch": 1, "repro_torch.models.dlrm": 1, "reprox": 1, "torch": 1}
    assert guard.forbidden_loaded(loaded) == []
    loaded.update({"repro.kernels": 1, "jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1})
    assert guard.forbidden_loaded(loaded) == ["flax.linen", "jax", "jaxlib.xla_client",
                                              "repro.kernels"]


def test_guard_finds_the_benchmark_process_clean(tiny_root):
    """A whole run in its own process: the run checks ``sys.modules`` itself
    before its last line, and would exit non-zero with no result."""
    from conftest import run_cell
    assert run_cell(tiny_root, "tiny-dlrm.tiny-score")["correct"] is True
