"""Layer-2 f32-accumulation auditor (ACC-002), the port's counterpart of
the JAX package's ``jaxpr_audit.py``: every program in
``programs.kernel_programs`` must accumulate in f32 (or wider).

Each program runs on ``ctx.device`` and is checked two ways:

* **dispatched dtypes** — the program runs under a
  ``TorchDispatchMode`` that sees every aten operation the plain versions
  (and the wrappers around the kernels) dispatch, and flags each
  floating-point contraction or reduction (``sum``, ``mean``, ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``, ``addmv``,
  ``_embedding_bag``) whose output is narrower than f32 — the
  ``dot_general`` / ``reduce_sum`` rule of the reference.  Integer and
  bool reductions are exempt, as there.  A CUDA kernel is opaque to the
  dispatcher, hence:
* **numerics** — the result against an f64 oracle of the same function
  on the same operands: within ``RTOL`` of the magnitude of its terms
  (the sum of their absolute values, the scale accumulation error takes).
  Where the program pools or contracts it is also run at the reference's
  accumulation shape (L=16, D=128, positive bf16 rows; there the
  magnitude is the value itself, so the bound is ``tests/test_kernels.py``'s
  rtol 5e-3), and a bf16 running sum of the same terms must *fail* that
  bound — else the check could not see low-precision accumulation.  On a
  CUDA device a program that names a kernel must launch it (its launch
  counter moves), or the audit did not reach the kernel.

Findings anchor at ``analysis://acc/<program>[cpu|cuda]``.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding
from .programs import KernelProgram, Oracle, kernel_programs
from .registry import Context, register_pass

__all__ = ["audit_program", "RTOL"]

_RULE = "ACC-002"
RTOL = 5e-3   # tests/test_kernels.py:84-107
_aten = torch.ops.aten
_AUDITED = {_aten.sum, _aten.mean, _aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
            _aten.dot, _aten.mv, _aten.addmv, _aten._embedding_bag,
            _aten._embedding_bag_forward_only}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _tensors(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _tensors(item)


class _NarrowAccumulation(TorchDispatchMode):
    """Records each audited floating-point operation with an output
    narrower than f32."""

    def __init__(self):
        super().__init__()
        self.narrow: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _AUDITED \
                and any(t.is_floating_point() for t in _tensors(args)):
            narrow = sorted({str(t.dtype) for t in _tensors(out)
                             if t.is_floating_point() and t.element_size() < 4})
            if narrow:
                self.narrow.append(f"{func.overloadpacket.__name__} accumulates in "
                                   f"{', '.join(narrow)} (< f32)")
        return out


def _rel_err(got: torch.Tensor, want: Oracle) -> float:
    """The worst |got - value| / magnitude over the output."""
    err = (got.detach().to("cpu", torch.float64) - want.value).abs()
    scale = want.magnitude.clamp_min(torch.finfo(torch.float64).tiny)
    return float((err / scale).max()) if err.numel() else 0.0


def _running_bf16(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """The terms summed in bf16, one rounding per add."""
    terms = terms.movedim(dim, 0).to(torch.bfloat16)
    acc = torch.zeros(terms.shape[1:], dtype=torch.bfloat16)
    for t in terms:
        acc = acc + t
    return acc


def audit_program(prog: KernelProgram, device) -> tuple[list[Finding], dict]:
    """Run one program (and its accumulation shape) on ``device``;
    return (findings, telemetry)."""
    device = torch.device(device)
    anchor = f"analysis://acc/{prog.name}[{device.type}]"
    row = {"name": prog.name, "device": str(device), "kernel": prog.kernel}

    def finding(message):
        return Finding(rule=_RULE, path=anchor, line=0, layer=2, message=message)

    counter = None
    if prog.kernel is not None and device.type == "cuda":
        from ..kernels import launch_counters
        counter = launch_counters()[prog.kernel]
    before = counter.launches if counter is not None else 0
    findings = []
    watch = _NarrowAccumulation()
    try:
        runs = [("program", *prog.build(device))]
        if prog.audit is not None:
            runs.append(("audit", *prog.audit(device)))
        for label, fn, args in runs:
            with watch:
                got = fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            want = prog.oracle(*args)
            rel = _rel_err(got, want)
            row[f"{label}_rel_err"] = rel
            if rel > RTOL:
                findings.append(finding(
                    f"{label} shape: result departs from the f64 oracle by {rel:.3g} "
                    f"of its terms' magnitude (> rtol {RTOL}) — low-precision "
                    "accumulation"))
            if label == "audit" and want.terms is not None:
                ctl_rel = _rel_err(_running_bf16(want.terms, want.dim), want)
                row["control_rel_err"] = ctl_rel
                if ctl_rel <= RTOL:
                    findings.append(finding(
                        f"a bf16 running sum of the audit shape's terms stays within "
                        f"rtol {RTOL} ({ctl_rel:.3g}) — the check cannot see "
                        "low-precision accumulation"))
    except Exception as e:
        return [finding(f"program failed to run: {e!r}")], {**row, "error": repr(e)}
    findings += [finding(f"{msg} — pass dtype=torch.float32 or upcast the operands")
                 for msg in sorted(set(watch.narrow))]
    if counter is not None:
        row["launches"] = counter.launches - before
        if row["launches"] == 0:
            findings.append(finding(f"no {prog.kernel} launch on {device} — the audit "
                                    "did not reach the kernel"))
    return findings, row


@register_pass(_RULE, "f32-accumulation", 2,
               "the kernel programs' contractions and reductions accumulate "
               "in f32: dispatched dtypes, and results against an f64 oracle")
def acc_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    rows = []
    for prog in kernel_programs():
        fs, row = audit_program(prog, ctx.device)
        findings += fs
        rows.append(row)
    ctx.notes[_RULE] = {"programs": rows}
    return findings
