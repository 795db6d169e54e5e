"""Carry parameter trees and train states between the JAX package and the port.

The caller hands over the tree with every leaf as a numpy array
(``jax.tree.map(np.asarray, params)``); dicts, lists and tuples keep their
structure, so dense, bf16 and int8-quantized tables (``{"q", "scale",
"zp"}``) all map one-to-one onto the port's layout.  A train state
(``{"params", "opt", "step"}``) carries its optimizer-state list (one dict
per parameter leaf, in leaf order, as both packages keep it) and its
int32 step the same way; a data-parallel state (``init_dp_state``) also
carries its error-feedback tree ``err`` (shaped like ``params``, 0-d
placeholders for uncompressed leaves).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "state_from_jax", "state_to_numpy"]


def _tensor(arr, device):
    arr = np.asarray(arr)
    # arrays handed out by jax are read-only; copy() keeps a 0-d array 0-d,
    # where np.ascontiguousarray would make it 1-d
    if not (arr.flags.c_contiguous and arr.flags.writeable):
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


def state_from_jax(state, device="cuda"):
    """A JAX train state ``{"params", "opt", "step"}`` (numpy leaves), or a
    data-parallel one with ``err`` as well, as the port's, on ``device``:
    the step a 0-d int32 tensor."""
    if set(state) not in ({"params", "opt", "step"}, {"params", "opt", "step", "err"}):
        raise ValueError("a train state holds params, opt and step (and err for the "
                         f"data-parallel step), got {sorted(state)}")
    out = {"params": params_from_jax(state["params"], device),
           "opt": params_from_jax(list(state["opt"]), device),
           "step": _tensor(np.asarray(state["step"], dtype=np.int32), device)}
    if "err" in state:
        out["err"] = params_from_jax(state["err"], device)
    return out


def state_to_numpy(tree):
    """The same tree with every tensor as a numpy array on the host; bf16
    leaves widen exactly to f32 (numpy has no bf16 of its own)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
