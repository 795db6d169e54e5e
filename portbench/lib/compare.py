"""The numbers that decide ``correct``, each against its limit."""

from __future__ import annotations

import math
import statistics


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def worst_leaf_gap(prog: list, ref: list, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    ``|‖a‖ − ‖b‖|``, against the larger of the reference's norm of that
    leaf and of the median leaf; ``keep`` masks the leaves that count."""
    keep = [True] * len(ref) if keep is None else keep
    kept = [r for r, k in zip(ref, keep) if k]
    med = statistics.median(kept)
    return max(abs(p - r) / max(r, med) for p, r, k in zip(prog, ref, keep) if k)


def rel_gap(prog: list, ref: list) -> float:
    """The largest ``|a − b| / |b|`` over paired scalars."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))
