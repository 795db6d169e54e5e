"""Per-leaf gradient-compression policy engine, as the JAX package's
``dist/policy.py``.

Embedding-table gradients are the wire-dominant tensors and tolerate
int8 (error feedback absorbs the quantisation), dense matmul gradients
want bf16, and norm gains, biases and tiny leaves are not worth
compressing: their bytes are noise but their precision is not.

Each gradient leaf (parameter path + shape) maps to a mode through an
ordered ``(path regex, mode)`` table, first match wins, with a size/rank
gate applied before the table (norms, biases and any leaf under
``min_compress_elems`` elements get ``small_mode`` whatever their name).
Paths are ``optim.optimizers.leaf_paths``'s, which equal the reference's
leaf for leaf.  The flat per-leaf mode list threads straight through
``compress.ef_psum_grads`` and ``compress.init_error_state``:
error-feedback state is allocated only for leaves that compress.

Extend by adding a ``(regex, mode)`` pair to a policy's ``rules``; do not
hardcode modes at call sites.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

from .. import tree
from ..optim.optimizers import leaf_paths
from .compress import MODES

__all__ = ["POLICY_RULES", "CompressionPolicy", "AUTO", "resolve_policy"]


# Ordered (path regex, mode) table.
POLICY_RULES: tuple[tuple[str, str], ...] = (
    # Embedding / hash tables: the memory-dominant tensors are also the
    # wire-dominant gradients; int8 + error feedback.
    (r"(^|/)(embed\w*|wte|tok_emb|tables?)(/|$)|(^|/)table_\d+($|/)", "int8"),
    # Norm / gain / bias leaves by name (rank-2 norm scales exist in some
    # archs, so the rank gate alone is not enough).
    (r"(^|/)(norm\w*|ln\w*|layernorm|rmsnorm|scale|gain|bias)($|/)", "none"),
)


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Path+shape → compression mode.

    Resolution order for ``mode_for(path, shape)``:
      1. rank ≤ 1 or fewer than ``min_compress_elems`` elements →
         ``small_mode``;
      2. first matching ``(regex, mode)`` rule in ``rules``;
      3. ``default`` (dense matmul gradients → bf16).
    """

    rules: tuple[tuple[str, str], ...] = POLICY_RULES
    default: str = "bf16"
    min_compress_elems: int = 2048
    small_mode: str = "none"

    def __post_init__(self):
        for _, mode in tuple(self.rules) + (("", self.default), ("", self.small_mode)):
            if mode not in MODES:
                raise ValueError(f"unknown compression mode {mode!r}; expected one of {MODES}")

    def mode_for(self, path: str, shape: Sequence[int]) -> str:
        shape = tuple(shape)
        if len(shape) <= 1 or math.prod(shape) < self.min_compress_elems:
            return self.small_mode
        for pattern, mode in self.rules:
            if re.search(pattern, path):
                return mode
        return self.default

    def modes(self, tree_like) -> list[str]:
        """Flat per-leaf mode list in leaf order (``tree.leaves``)."""
        return [self.mode_for(p, leaf.shape)
                for p, leaf in zip(leaf_paths(tree_like), tree.leaves(tree_like))]

    def tree(self, tree_like):
        """Tree of mode strings matching ``tree_like``'s structure."""
        return tree.unflatten(tree_like, self.modes(tree_like))


# The default policy: int8 tables, bf16 dense, none for norms/bias/small.
AUTO = CompressionPolicy()


def resolve_policy(policy) -> "CompressionPolicy | str":
    """Accepts a mode string, ``"auto"``, or a CompressionPolicy."""
    if isinstance(policy, CompressionPolicy):
        return policy
    if policy == "auto":
        return AUTO
    if policy in MODES:
        return policy
    raise ValueError(f"unknown compression policy {policy!r}; expected one of "
                     f"{MODES + ('auto',)} or a CompressionPolicy")
