"""Findings, ``# repro: noqa[RULE-ID]`` suppressions, and output formats —
the same as the JAX package's ``analysis/findings.py``, so a report of
either analyzer renders through ``benchmarks/summary_md.py --analysis``.

A :class:`Finding` is one violation of one registered rule, anchored to a
repo-relative path and 1-based line (layer-2 auditors that certify traced
programs rather than source lines anchor to the *program registry* entry
that failed, with line 0 — there is no source line to suppress, which is
deliberate: trace-level invariants cannot be waived inline).

Suppression follows the linter convention the repo already uses for ruff,
with a namespaced marker so the two never collide::

    acc = rows.sum(axis=0)          # repro: noqa[ACC-001] scratch is f32
    t0 = time.monotonic()           # repro: noqa — host-side metrics

``# repro: noqa[A, B]`` waives rules A and B on that line; a bare
``# repro: noqa`` waives every rule.  Suppressed findings stay in the
JSON report (``suppressed: true``) so CI artifacts show what was waived,
but they do not fail the run.
"""

from __future__ import annotations

import dataclasses
import json
import re

__all__ = ["Finding", "suppressions_for", "apply_suppressions",
           "format_findings", "report_dict", "FORMATS"]

FORMATS = ("human", "json", "github")

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([A-Za-z0-9_,\s-]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # registered rule id, e.g. "ACC-001"
    path: str            # repo-relative path ("analysis://..." for layer 2)
    line: int            # 1-based; 0 = not source-anchored
    message: str
    layer: int = 1
    suppressed: bool = False

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def suppressions_for(text: str) -> dict[int, frozenset[str] | None]:
    """Map of 1-based line -> waived rule ids (``None`` = all rules)."""
    out: dict[int, frozenset[str] | None] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        rules = m.group(1)
        if rules is None:
            out[i] = None
        else:
            ids = frozenset(r.strip().upper() for r in rules.split(",")
                            if r.strip())
            out[i] = ids or None
    return out


def apply_suppressions(findings: list[Finding],
                       text_for: dict[str, str]) -> list[Finding]:
    """Mark findings whose anchor line carries a matching noqa.

    ``text_for`` maps repo-relative path -> file text (the analyzer's
    source cache); findings for paths outside it pass through unchanged.
    """
    cache: dict[str, dict] = {}
    out = []
    for f in findings:
        text = text_for.get(f.path)
        if text is None or f.line <= 0:
            out.append(f)
            continue
        if f.path not in cache:
            cache[f.path] = suppressions_for(text)
        waived = cache[f.path].get(f.line, ...)
        if waived is ... :
            out.append(f)
        elif waived is None or f.rule.upper() in waived:
            out.append(dataclasses.replace(f, suppressed=True))
        else:
            out.append(f)
    return out


def report_dict(findings: list[Finding], passes: list[dict],
                root: str) -> dict:
    """The JSON artifact: every finding (suppressed ones marked), the
    per-pass roll-up, and the overall verdict CI gates on."""
    live = [f for f in findings if not f.suppressed]
    return {
        "root": root,
        "ok": not live,
        "findings": [f.as_dict() for f in findings],
        "counts": {"total": len(findings), "unsuppressed": len(live),
                   "suppressed": len(findings) - len(live)},
        "passes": passes,
    }


def _human(findings: list[Finding]) -> str:
    lines = []
    for f in findings:
        sup = "  [suppressed]" if f.suppressed else ""
        anchor = f"{f.path}:{f.line}" if f.line > 0 else f.path
        lines.append(f"{anchor}: {f.rule} {f.message}{sup}")
    live = sum(1 for f in findings if not f.suppressed)
    lines.append(f"{live} finding(s), "
                 f"{len(findings) - live} suppressed")
    return "\n".join(lines)


def _github(findings: list[Finding]) -> str:
    """GitHub workflow annotations: ``::error`` per unsuppressed finding
    (suppressed ones become notices so the waiver stays visible)."""
    lines = []
    for f in findings:
        kind = "notice" if f.suppressed else "error"
        msg = f"{f.rule} {f.message}".replace("%", "%25") \
            .replace("\r", "%0D").replace("\n", "%0A")
        loc = f"file={f.path},line={max(f.line, 1)}" if f.line > 0 \
            else f"file={f.path}"
        lines.append(f"::{kind} {loc},title={f.rule}::{msg}")
    live = sum(1 for f in findings if not f.suppressed)
    lines.append(f"{live} unsuppressed finding(s)")
    return "\n".join(lines)


def format_findings(findings: list[Finding], fmt: str, *,
                    passes: list[dict] | None = None,
                    root: str = ".") -> str:
    if fmt == "human":
        return _human(findings)
    if fmt == "github":
        return _github(findings)
    if fmt == "json":
        return json.dumps(report_dict(findings, passes or [], root),
                          indent=2)
    raise ValueError(f"format {fmt!r} not in {FORMATS}")
