"""The run's own import check: the JAX package and JAX must never load in
a benchmark process.  Names compare by the whole top-level module name
(the part before the first dot): ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})
