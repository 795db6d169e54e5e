"""The port's checkpointer: the reference's tests (``tests/test_ckpt.py``)
mirrored on the port, and checkpoints interchanged with the JAX package in
both directions (same files, same manifest, same leaf order).  Restored
values must equal the saved ones exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.models import dlrm as jdlrm
from repro.core import EmbeddingSpec as JSpec
from repro.optim import optimizers as jopt
from repro.train import loop as jloop
from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import state_from_jax, state_to_numpy


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "tables": [torch.randn((10, 2), generator=g),
                                  torch.randn((5, 2), generator=g)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    state = _tree()
    ckpt.save(str(tmp_path), 7, state)
    restored, manifest = ckpt.restore(str(tmp_path), 7, state)
    assert manifest["step"] == 7
    _assert_equal(state, restored)


def test_latest_and_prune(tmp_path):
    state = _tree()
    for s in (10, 20, 30, 40):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [30, 40]
    assert ckpt.latest_step(str(tmp_path)) == 40


def test_corrupt_falls_back_to_previous(tmp_path):
    state = _tree()
    ckpt.save(str(tmp_path), 10, state)
    ckpt.save(str(tmp_path), 20, state)
    d = os.path.join(str(tmp_path), "step_00000020")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, manifest["leaves"][0]["file"]), "wb") as f:
        f.write(b"garbage")
    step, restored, _ = ckpt.restore_latest(str(tmp_path), state)
    assert step == 10 and restored is not None
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 20, state)


def test_interrupted_write_is_invisible(tmp_path):
    ckpt.save(str(tmp_path), 10, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_async_checkpointer(tmp_path):
    state = _tree()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(5, state)
    ac.save(6, state)  # waits for 5 internally
    ac.wait()
    assert ckpt.available_steps(str(tmp_path)) == [5, 6]
    _assert_equal(state, ckpt.restore(str(tmp_path), 6, state)[0])


def test_restore_respects_target_dtype(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones((4, 4))})
    restored, _ = ckpt.restore(str(tmp_path), 1, {"w": torch.empty((4, 4),
                                                                    dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.ones((4, 4)))


def test_leaf_count_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_bf16_leaves_roundtrip_bit_for_bit(tmp_path):
    state = {"w": torch.randn((5, 3), generator=torch.Generator().manual_seed(1)
                              ).to(torch.bfloat16)}
    ckpt.save(str(tmp_path), 1, state)
    _assert_equal(state, ckpt.restore(str(tmp_path), 1, state)[0])


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The host snapshot is taken when ``save`` is called: a later in-place
    change of the live state does not reach the file."""
    state = {"w": torch.zeros(4)}
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(1, state)
    state["w"].add_(1.0)
    ac.wait()
    assert torch.equal(ckpt.restore(str(tmp_path), 1, state)[0]["w"], torch.zeros(4))


# ------------------------------------------- interchange with the JAX package


def _jax_train_state():
    cfg = jdlrm.DLRMConfig(table_sizes=(40, 300, 7), emb_dim=4, bottom_mlp=(8, 4),
                           top_mlp=(8,), embedding=JSpec(kind="qr", num_collisions=4,
                                                         threshold=10))
    opt = jopt.partitioned([(lambda p: "tables" in p, jopt.rowwise_adagrad(1e-2))],
                           jopt.adam(1e-3, amsgrad=True))
    state = jloop.init_state(jdlrm.dlrm_init(jax.random.PRNGKey(3), cfg), opt)
    # non-zero optimizer state and step
    state["opt"] = jax.tree.map(lambda x: x + 0.25, state["opt"])
    state["step"] = jnp.int32(17)
    return state


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_train_state()
    jckpt.save(str(tmp_path), 17, jstate)
    like = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    like = tree.tree_map(torch.zeros_like, like)
    step, restored, manifest = ckpt.restore_latest(str(tmp_path), like)
    assert step == 17 and manifest["step"] == 17
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 17
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    got = tree.leaves(state_to_numpy(restored))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    jstate = _jax_train_state()
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    ckpt.save(str(tmp_path), 17, tstate)
    # the same file names as the reference writes for the same state
    jckpt.save(str(tmp_path / "ref"), 17, jstate)
    with open(tmp_path / "step_00000017" / "manifest.json") as f:
        ours = json.load(f)["leaves"]
    with open(tmp_path / "ref" / "step_00000017" / "manifest.json") as f:
        theirs = json.load(f)["leaves"]
    assert [(e["file"], e["shape"], e["dtype"]) for e in ours] \
        == [(e["file"], e["shape"], e["dtype"]) for e in theirs]
    like = jax.tree.map(jnp.zeros_like, jstate)
    step, restored, _ = jckpt.restore_latest(str(tmp_path), like)
    assert step == 17
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    """The reference writes a bf16 leaf as its 16 bits (a 2-byte void
    array); the port reads those bits back as bf16."""
    w = jnp.asarray(np.random.default_rng(0).normal(size=(6, 2)), jnp.bfloat16)
    jckpt.save(str(tmp_path), 1, {"w": w})
    restored, _ = ckpt.restore(str(tmp_path), 1, {"w": torch.empty((6, 2),
                                                                   dtype=torch.bfloat16)})
    np.testing.assert_array_equal(restored["w"].float().numpy(), np.asarray(w, np.float32))
