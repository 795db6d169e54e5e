"""The port's public surface against the reference's, by ``ast`` alone.

Both trees are parsed, never imported.  Every module of ``src/repro`` has
a module of ``src/repro_torch`` at the same relative path, and every
public name of a reference module is defined or imported at the top level
of its port module.  A module's public names are its ``__all__``; a module
without one exports the names it defines at its top level that do not
start with an underscore.  What the port leaves out on purpose stands in
``EXEMPT`` with its reason; a second case keeps that table from going
stale.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# (reference module, name or None for the whole module) -> why the port has
# no counterpart there; a stand-in module is named in the reason and must exist
EXEMPT = {
    ("_compat/__init__.py", None): "the JAX package's tests' hypothesis stub",
    ("_compat/hypothesis_stub.py", None): "the JAX package's tests' hypothesis stub",
    ("analysis/jaxpr_audit.py", None):
        "no jaxpr: analysis/acc_audit.py audits the dispatched dtypes instead",
    ("launch/hlo_analysis.py", None):
        "no HLO: launch/cost_analysis.py counts the program under DTensor instead",
    ("kernels/__init__.py", "on_tpu"): "no TPU: the kernels run on the card or raise",
    ("kernels/ops.py", "on_tpu"): "no TPU: the kernels run on the card or raise",
    ("analysis/registry.py", "DEFAULT_SCAN_DIRS"):
        "the port scans its own tree, the glob patterns of DEFAULT_SCAN",
    **{("kernels/ref.py", f"{k}_ref"): "kernels/ref.py names the plain versions without "
       "_ref, so the JAX analyzer's ACC-001 does not flag the port's kernel files"
       for k in ("qr_gather", "qr_gather_quant", "qr_embedding_bag", "fused_serve_pool",
                 "dot_interaction")},
}
STAND_INS = {"analysis/jaxpr_audit.py": "analysis/acc_audit.py",
             "launch/hlo_analysis.py": "launch/cost_analysis.py"}


def _top_level(body, out_all, defined, bound):
    """Walk a module body (and the bodies of its top-level ``if`` / ``try``
    / ``with`` blocks): ``defined`` gets the names it defines, ``bound``
    those and the names it imports, ``out_all`` its ``__all__``."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                defined.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
                if isinstance(node, ast.Assign) and getattr(target, "id", None) == "__all__":
                    out_all.extend(ast.literal_eval(node.value))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for block in [node.body, getattr(node, "orelse", []), getattr(node, "finalbody", [])] \
                    + [h.body for h in getattr(node, "handlers", [])]:
                _top_level(block, out_all, defined, bound)
    bound |= defined


def _names(path: Path):
    """(public names, every name bound at the top level) of a module."""
    out_all, defined, bound = [], set(), set()
    _top_level(ast.parse(path.read_text(), filename=str(path)).body, out_all, defined, bound)
    if out_all:
        return out_all, bound
    return sorted(n for n in defined if not n.startswith("_")), bound


def _ref_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _missing():
    """(module, name) pairs of the reference the port lacks: name None for
    a whole module."""
    out = []
    for rel in _ref_modules():
        port = PORT / rel
        if not port.exists():
            out.append((rel, None))
            continue
        public, _ = _names(REF / rel)
        _, bound = _names(port)
        out += [(rel, n) for n in public if n not in bound]
    return out


def test_every_public_name_of_the_reference_is_in_the_port():
    assert len(_ref_modules()) > 80
    unexplained = [m for m in _missing() if m not in EXEMPT]
    assert not unexplained, (
        "the port lacks these (reference module, name) pairs; add them, or exempt "
        f"them with a reason: {unexplained}")


def test_the_exemption_table_has_no_stale_entry():
    missing = set(_missing())
    stale = [k for k in EXEMPT if k not in missing]
    assert not stale, f"exempted but present in the port: {stale}"
    for rel, stand_in in STAND_INS.items():
        assert (rel, None) in EXEMPT and (PORT / stand_in).exists()
    assert all(reason.strip() for reason in EXEMPT.values())


@pytest.mark.parametrize("rel", ["serve/__init__.py", "dist/__init__.py"])
def test_the_package_re_exports_resolve(rel):
    """The reference package's re-exports import from the port's package
    and stand in its ``__all__``."""
    import importlib

    module = importlib.import_module("repro_torch." + rel.removesuffix("/__init__.py")
                                     .replace("/", "."))
    public, _ = _names(REF / rel)
    assert set(public) <= set(module.__all__)
    assert all(hasattr(module, n) for n in module.__all__)
