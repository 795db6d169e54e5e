"""Pluggable pass registry + shared analysis context.

A *pass* is a function ``(ctx: Context) -> list[Finding]`` registered
under a stable rule id.  Layer 1 passes are pure-AST (stdlib ``ast``
over the source tree, no torch import); layer 2 passes run real programs
on ``ctx.device`` — kernels, exchanges in a world of ``ctx.world`` ranks,
the serving engine, the planner — so they need torch.

The CLI runs every registered pass by default; ``--select``/``--skip``
and ``--layer`` narrow the set.  New invariants plug in by decorating a
function with :func:`register_pass` from any module ``load_passes``
imports.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
from typing import Callable

from .findings import Finding

__all__ = ["PassInfo", "PASSES", "register_pass", "Context",
           "DEFAULT_SCAN", "EXCLUDE_PARTS"]

# what the AST passes scan by default, relative to the repo root (glob
# patterns): the port's own tree — its package, its smoke script and its
# tests.  ``--paths`` / ``--root`` reach anything else.
DEFAULT_SCAN = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py")
# path components that exclude a file from a directory walk: the seeded-
# violation fixtures *must* trip the analyzer when pointed at directly,
# and must not fail the clean-tree gate
EXCLUDE_PARTS = ("analysis_fixtures", "__pycache__", ".git")


@dataclasses.dataclass(frozen=True)
class PassInfo:
    id: str                    # rule id, e.g. "ACC-001"
    name: str                  # short slug, e.g. "kernel-accumulation"
    layer: int                 # 1 = AST, 2 = run-level
    description: str
    fn: Callable[["Context"], list[Finding]]


PASSES: dict[str, PassInfo] = {}


def register_pass(id: str, name: str, layer: int, description: str):
    def deco(fn):
        if id in PASSES:
            raise ValueError(f"duplicate analysis pass id {id!r}")
        PASSES[id] = PassInfo(id=id, name=name, layer=layer,
                              description=description, fn=fn)
        return fn
    return deco


def _walk_dir(top: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in EXCLUDE_PARTS]
        out += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return out


class Context:
    """Shared state for one analyzer run: the scan root, parsed-AST cache,
    and knobs the CLI threads through (extra plan paths, fixture paths,
    the device and world size of the layer-2 passes).

    ``paths`` (when given) replaces the default scan — the fixture tests
    point a context straight at one seeded-violation file.
    """

    def __init__(self, root: str = ".", *, paths: list[str] | None = None,
                 plan_paths: list[str] | None = None, device: str = "cuda",
                 world: int = 4):
        self.root = os.path.abspath(root)
        self.paths = paths
        self.plan_paths = list(plan_paths or [])
        self.device = device
        self.world = world
        self._sources: dict[str, str] | None = None
        self._trees: dict[str, ast.AST] = {}
        self.notes: dict[str, object] = {}   # per-pass scratch/telemetry

    # ------------------------------------------------------------ sources

    def _walk(self) -> list[str]:
        out = []
        if self.paths is not None:
            for p in self.paths:
                p = p if os.path.isabs(p) else os.path.join(self.root, p)
                if os.path.isdir(p):
                    out += _walk_dir(p)
                elif p.endswith(".py"):
                    out.append(p)
            return sorted(out)
        for pattern in DEFAULT_SCAN:
            for p in glob.glob(os.path.join(self.root, pattern)):
                if os.path.isdir(p):
                    out += _walk_dir(p)
                elif p.endswith(".py"):
                    out.append(p)
        return sorted(out)

    def sources(self) -> dict[str, str]:
        """repo-relative path -> file text, cached for the whole run."""
        if self._sources is None:
            self._sources = {}
            for p in self._walk():
                rel = os.path.relpath(p, self.root)
                try:
                    with open(p, encoding="utf-8") as f:
                        self._sources[rel] = f.read()
                except OSError:
                    continue
        return self._sources

    def tree(self, rel_path: str) -> ast.AST | None:
        if rel_path not in self._trees:
            text = self.sources().get(rel_path)
            if text is None:
                return None
            try:
                self._trees[rel_path] = ast.parse(text, filename=rel_path)
            except SyntaxError:
                self._trees[rel_path] = None  # ruff's E9 lane owns these
        return self._trees[rel_path]

    def iter_trees(self):
        for rel in self.sources():
            t = self.tree(rel)
            if t is not None:
                yield rel, t
