"""``repro_torch.analysis`` — the port of the JAX package's static
invariant checker (``repro/analysis``), over the port: it guards the
properties the port's later changes must keep (see each pass's module
docstring):

* layer 1 — pure-AST lint passes (``ast_passes``), no torch needed;
* layer 2 — run-level auditors on ``--device`` (``acc_audit``,
  ``wire_audit``, ``jit_audit``, ``injectivity``): the kernels' and plain
  versions' accumulation dtype, collective bytes against their closed
  forms in a world of ranks, the serving engine's shape stability, and
  the plans' partition codes.

Run ``python -m repro_torch.analysis`` (see ``cli``) or call
:func:`load_passes` + :func:`registry.PASSES` programmatically.
"""

from .findings import Finding, format_findings, report_dict  # noqa: F401
from .registry import PASSES, Context, register_pass  # noqa: F401

_LAYER1_MODULES = ("ast_passes",)
_LAYER2_MODULES = ("acc_audit", "wire_audit", "jit_audit", "injectivity")


def load_passes(layer: str = "all") -> dict:
    """Import the pass modules (side effect: registration) and return the
    registry.  ``layer``: ``"1"`` (AST only — no torch import), ``"2"``,
    or ``"all"``."""
    import importlib
    mods = ()
    if layer in ("1", "all"):
        mods += _LAYER1_MODULES
    if layer in ("2", "all"):
        mods += _LAYER2_MODULES
    for m in mods:
        importlib.import_module(f".{m}", __name__)
    return PASSES
