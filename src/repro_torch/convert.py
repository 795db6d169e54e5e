"""Carry a parameter tree from the JAX package into the port.

The caller hands over the tree with every leaf as a numpy array
(``jax.tree.map(np.asarray, params)``); dicts, lists and tuples keep their
structure, so dense, bf16 and int8-quantized tables (``{"q", "scale",
"zp"}``) all map one-to-one onto the port's layout.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _tensor(arr, device):
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # arrays handed out by jax are read-only
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        # numpy's bf16 (ml_dtypes) is not a dtype torch.from_numpy takes:
        # carry the same 16 bits as uint16 and reinterpret them
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(tree, device="cuda"):
    """The same tree with every numpy leaf as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _tensor(tree, device)
