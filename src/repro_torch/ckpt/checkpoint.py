"""Fault-tolerant checkpointing (numpy + JSON), in the JAX package's format.

Layout per step::

    <dir>/step_000100/
        manifest.json      # step, tree description, shape, dtype, sha256 per file
        <leaf-path>.npy    # one file per leaf

Leaves are written in ``jax.tree.leaves`` order (``repro_torch.tree``) and
named as the reference names them, so a checkpoint written by either
package restores in the other.  A bf16 leaf is stored as the reference
stores one: its 16 bits as a 2-byte void ``.npy`` with dtype ``bfloat16``
in the manifest.

Fault-tolerance properties:
  * **atomic publish** — written to ``step_X.tmp`` then ``os.replace``d, so
    a crash mid-write never yields a half checkpoint that restore trusts;
  * **integrity** — restore verifies sha256 per leaf and falls back to the
    newest *valid* checkpoint (``restore_latest`` walks backwards);
  * **async** — ``AsyncCheckpointer`` snapshots device tensors to host
    memory, then writes on a background thread (training continues during
    I/O);
  * **elastic restore** — ``restore(..., shardings=...)`` hands each rank
    its block of every leaf (``dist.sharding.Shard``), so a state saved
    with full leaves restores onto a world of another size.  An FSDP state
    is saved full (``train.loop.gather_fsdp_state``, written by one rank)
    and restored through ``train.loop.fsdp_state_shardings``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from .. import tree

__all__ = ["save", "restore", "restore_latest", "latest_step", "AsyncCheckpointer",
           "available_steps"]

_BF16 = "bfloat16"


def _leaf_files(state) -> list[str]:
    names = ["_".join(str(k) for k in path).replace("/", "_")
             for path, _ in tree.flatten_with_path(state)]
    # disambiguate duplicates deterministically
    seen: dict[str, int] = {}
    out = []
    for n in names:
        c = seen.get(n, 0)
        seen[n] = c + 1
        out.append(f"{n}__{c}" if c else n)
    return out


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_host(leaf):
    """A leaf as a numpy array, and the dtype name the manifest records."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, state, *, keep: int = 3, extra: dict | None = None):
    """Write checkpoint for ``step``; prunes to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = tree.flatten_with_path(state)
    manifest = {"step": step, "treedef": repr([path for path, _ in flat]),
                "extra": extra or {}, "leaves": []}
    for (_, leaf), fname in zip(flat, _leaf_files(state)):
        arr, dtype = _to_host(leaf)
        fpath = os.path.join(tmp, fname + ".npy")
        np.save(fpath, arr)
        manifest["leaves"].append({"file": fname + ".npy", "shape": list(arr.shape),
                                   "dtype": dtype, "sha256": _sha256(fpath)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _valid(path: str, verify: bool) -> bool:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for entry in manifest["leaves"]:
            fpath = os.path.join(path, entry["file"])
            if not os.path.exists(fpath):
                return False
            if verify and _sha256(fpath) != entry["sha256"]:
                return False
        return True
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def _load(path, entry) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like, *, shardings=None, verify: bool = True):
    """Load checkpoint ``step`` into the structure of ``like``: each leaf a
    tensor in the dtype and on the device of ``like``'s leaf (a leaf that
    is no tensor keeps the stored dtype, on the CPU).

    ``shardings``: a tree like ``like`` of ``dist.sharding.Shard`` (or one
    ``Shard`` for every leaf) — each leaf is cut to this rank's block
    before it moves to the device, which is how a checkpoint restores
    onto another world size."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _valid(path, verify):
        raise IOError(f"checkpoint at {path} is missing or corrupt")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = tree.leaves(like)
    entries = manifest["leaves"]
    if len(entries) != len(leaves_like):
        raise ValueError(f"checkpoint has {len(entries)} leaves, expected {len(leaves_like)}")
    if shardings is None:
        shard_leaves = [None] * len(entries)
    else:
        shard_leaves = tree.leaves(shardings)
        if len(shard_leaves) == 1 and len(entries) > 1:
            shard_leaves = shard_leaves * len(entries)
        if len(shard_leaves) != len(entries):
            raise ValueError(f"shardings has {len(shard_leaves)} leaves, the checkpoint "
                             f"{len(entries)}")
    out = []
    for entry, like_leaf, shd in zip(entries, leaves_like, shard_leaves):
        t = _load(path, entry)
        if shd is not None and shd.count > 1:
            t = shd.take(t).clone()     # the block alone, not a view of the whole leaf
        if torch.is_tensor(like_leaf):
            t = t.to(device=like_leaf.device, dtype=like_leaf.dtype)
        out.append(t)
    return tree.unflatten(like, out), manifest


def restore_latest(ckpt_dir: str, like, *, shardings=None, verify: bool = True):
    """Restore the newest checkpoint whose integrity check passes:
    ``(step, state, manifest)``, or three Nones."""
    for step in reversed(available_steps(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        if _valid(path, verify):
            state, manifest = restore(ckpt_dir, step, like, shardings=shardings,
                                      verify=False)
            return step, state, manifest
    return None, None, None


class AsyncCheckpointer:
    """Snapshot to host memory immediately, persist on a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state, extra: dict | None = None):
        self.wait()
        host = tree.tree_map(lambda x: x.detach().to("cpu", copy=True)
                             if torch.is_tensor(x) else np.asarray(x), state)

        def _run():
            try:
                save(self.ckpt_dir, step, host, keep=self.keep, extra=extra)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
