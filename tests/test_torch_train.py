"""The port's training path held against the reference.

* DLRM loss, metrics and gradients (``train.loop.value_and_grad``) against
  ``jax.value_and_grad(..., has_aux=True)`` on JAX-initialised parameters
  for every table kind;
* one ``make_train_step`` step against the JAX step (``sgd`` with
  momentum, ``clip_norm``, ``accum=2``), and ``accum=2`` against
  ``accum=1``;
* the reference's fault-tolerance tests (``tests/test_train_fault_tolerance.py``)
  on the port: kill-and-restart replays bit for bit, the watchdog flags a
  straggler, training reduces the loss (on the reference's batches);
* ``ShardedLoader``'s prefetch and ``seek``; the config ``api``'s optimizer
  and training batch structure.

Tolerances: f32 1e-5 (``tests/test_kernels.py:12``), relative to each
leaf's largest gradient; the ``accum`` pair within the reference's own
bounds (loss 5e-5, parameters 2e-4, ``tests/test_train_fault_tolerance.py:67``).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_criteo as jcriteo
from repro.configs.common import Shape as JShape
from repro.core import EmbeddingSpec as JSpec
from repro.data.criteo import CriteoSpec as JCriteoSpec
from repro.data.criteo import batch_at as jbatch_at
from repro.models import dlrm as jdlrm
from repro.optim import optimizers as jopt
from repro.train import loop as jloop
from repro_torch import tree
from repro_torch.configs import dcn_criteo, dlrm_criteo
from repro_torch.configs.common import Shape
from repro_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.data.loader import ShardedLoader
from repro_torch.models import dlrm as tdlrm
from repro_torch.optim import optimizers as topt
from repro_torch.plan import power_law_stats, uniform_hash_plan
from repro_torch.train import loop as tloop

SIZES = (100, 500, 33, 2000)
KINDS = {
    "full": dict(kind="full"),
    "hash": dict(kind="hash", num_collisions=8),
    "qr_mult": dict(kind="qr", num_collisions=4, threshold=40),
    "qr_add": dict(kind="qr", num_collisions=4, op="add"),
    "qr_concat": dict(kind="qr", num_collisions=4, op="concat"),
    "feature": dict(kind="feature", num_collisions=4),
    "path": dict(kind="path", num_collisions=4, path_hidden=8),
    "mixed_radix": dict(kind="mixed_radix"),
}


def _cfgs(spec_kw, **kw):
    base = dict(table_sizes=SIZES, emb_dim=8, bottom_mlp=(32, 8), top_mlp=(32, 16), **kw)
    return (jdlrm.DLRMConfig(embedding=JSpec(**spec_kw), **base),
            tdlrm.DLRMConfig(embedding=TSpec(**spec_kw), **base))


def _np_batch(b=16, seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(b, 13)).astype(np.float32),
            "sparse": np.stack([rng.integers(0, s, size=b) for s in sizes],
                               axis=1).astype(np.int32),
            "label": (rng.random(b) > 0.5).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_leaves_close(jtree, ttree, tol):
    """Each leaf within ``tol`` of the reference's, relative to that
    leaf's largest magnitude (floored at 1)."""
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    tl = tree.leaves(state_to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * max(1.0, float(np.abs(a).max())))


@pytest.mark.parametrize("kind", list(KINDS))
def test_dlrm_loss_metrics_and_gradients_match_reference(kind):
    jcfg, tcfg = _cfgs(KINDS[kind])
    jp = jdlrm.dlrm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch = _np_batch()
    (jloss, jm), jg = jax.value_and_grad(lambda p, b: jdlrm.dlrm_loss_fn(p, b, jcfg),
                                         has_aux=True)(jp, _jb(batch))
    (tloss, tm), tg = tloop.value_and_grad(lambda p, b: tdlrm.dlrm_loss_fn(p, b, tcfg))(
        tp, _tb(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    np.testing.assert_allclose(float(tm["bce"]), float(jm["bce"]), rtol=1e-5)
    _assert_leaves_close(jg, tg, 1e-5)
    assert not tloss.requires_grad and not any(g.requires_grad for g in tree.leaves(tg))
    # the parameters handed in are untouched: no grad flag, no .grad
    assert not any(p.requires_grad or p.grad is not None for p in tree.leaves(tp))


def test_kernel_route_on_the_cpu_stays_differentiable():
    """``use_kernel=True`` on CPU tensors takes the kernels' plain
    versions, which autograd differentiates: the same gradients as the
    plain route."""
    _, tcfg = _cfgs(KINDS["qr_mult"])
    tp = tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _tb(_np_batch(seed=1))
    grads = {}
    for use_kernel in (False, True):
        cfg = dataclasses.replace(tcfg, use_kernel=use_kernel)
        _, grads[use_kernel] = tloop.value_and_grad(
            lambda p, b, cfg=cfg: tdlrm.dlrm_loss_fn(p, b, cfg))(tp, batch)
    for a, b in zip(tree.leaves(grads[False]), tree.leaves(grads[True])):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert any(float(g.abs().max()) > 0 for g in tree.leaves(grads[True]["tables"]))


def _step_pair(opt_name, **kw):
    """One JAX and one port step from the same state and batch."""
    make = {"sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
            "adagrad": lambda m: m.adagrad(1e-2),
            "amsgrad": lambda m: m.adam(1e-3, amsgrad=True)}[opt_name]
    jcfg, tcfg = _cfgs(KINDS["qr_mult"])
    jo, to = make(jopt), make(topt)
    jstate = jloop.init_state(jdlrm.dlrm_init(jax.random.PRNGKey(4), jcfg), jo)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    batch = _np_batch(b=32, seed=5)
    jstep = jax.jit(jloop.make_train_step(lambda p, b: jdlrm.dlrm_loss_fn(p, b, jcfg), jo, **kw))
    jnew, jm = jstep(jstate, _jb(batch))
    tnew, tm = tloop.make_train_step(lambda p, b: tdlrm.dlrm_loss_fn(p, b, tcfg), to, **kw)(
        tstate, _tb(batch))
    return jnew, jm, tnew, tm, tstate


@pytest.mark.parametrize("opt_name,kw", [("sgd_momentum", {}), ("adagrad", {"clip_norm": 0.1}),
                                         ("amsgrad", {"accum": 2}), ("adagrad", {})])
def test_train_step_matches_reference(opt_name, kw):
    jnew, jm, tnew, tm, tstate = _step_pair(opt_name, **kw)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)
    assert tnew["step"].dtype == torch.int32 and int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tstate["step"]) == 0                      # the step is functional
    _assert_leaves_close(jnew["params"], tnew["params"], 1e-5)
    _assert_leaves_close(jnew["opt"], tnew["opt"], 1e-5)


def test_grad_accumulation_equivalent():
    """accum=2 matches accum=1 (same global batch), within the reference's
    own bounds."""
    _, tcfg = _cfgs(KINDS["qr_mult"])
    opt = topt.adagrad(1e-2)
    p0 = tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(2), device="cpu")
    batch = _tb(_np_batch(b=64, seed=6))
    out = {}
    for accum in (1, 2):
        step = tloop.make_train_step(lambda p, b: tdlrm.dlrm_loss_fn(p, b, tcfg), opt,
                                     accum=accum)
        out[accum] = step(tloop.init_state(p0, opt), batch)
    (s1, m1), (s2, m2) = out[1], out[2]
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-5
    for a, b in zip(tree.leaves(s1["params"]), tree.leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


# --------------------------- the reference's tests/test_train_fault_tolerance.py

SPEC = JCriteoSpec(table_sizes=(100, 5000, 33))
CFG = tdlrm.DLRMConfig(table_sizes=SPEC.table_sizes,
                       embedding=TSpec(kind="qr", num_collisions=4, threshold=50))


def _loss_fn(p, b):
    return tdlrm.dlrm_loss_fn(p, b, CFG)


def _opt():
    return topt.partitioned([(lambda p: "tables" in p, topt.rowwise_adagrad(1e-2))],
                            topt.adam(1e-3, amsgrad=True))


def _ref_batches(n, size):
    """The reference's stream, drawn once by ``repro.data.criteo.batch_at``."""
    return [_tb(jax.tree.map(np.asarray, jbatch_at(0, s, size, SPEC))) for s in range(n)]


def test_kill_restart_bitwise_determinism(tmp_path):
    opt = _opt()
    state0 = tloop.init_state(tdlrm.dlrm_init(CFG, torch.Generator().manual_seed(1), "cpu"),
                              opt)
    tc = tloop.TrainConfig(num_steps=20, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=5)
    batches = _ref_batches(20, 64)

    tr = tloop.Trainer(tloop.make_train_step(_loss_fn, opt), tc, batch_at=batches.__getitem__)
    with pytest.raises(tloop.SimulatedFailure):
        tr.run(state0, fail_at_step=15)
    tr.checkpointer.wait()

    tr2 = tloop.Trainer(tloop.make_train_step(_loss_fn, opt), tc, batch_at=batches.__getitem__)
    resumed = tr2.resume_or(state0)
    assert int(resumed["step"]) == 10
    final_resumed, hist_resumed = tr2.run(resumed)

    tr3 = tloop.Trainer(tloop.make_train_step(_loss_fn, opt),
                        tloop.TrainConfig(num_steps=20, ckpt_dir=None, log_every=5),
                        batch_at=batches.__getitem__)
    final_direct, hist_direct = tr3.run(state0)
    for a, b in zip(tree.leaves(final_resumed), tree.leaves(final_direct)):
        assert torch.equal(a, b)
    assert hist_resumed == [h for h in hist_direct if h[0] >= 10]


def test_training_reduces_loss():
    """150 Adagrad steps on the reference's batches: the mean loss of the
    last 10 steps falls 0.05 below the first 10's, as the reference's does."""
    opt = topt.adagrad(1e-2)
    state = tloop.init_state(tdlrm.dlrm_init(CFG, torch.Generator().manual_seed(0), "cpu"), opt)
    step = tloop.make_train_step(_loss_fn, opt)
    losses = []
    for batch in _ref_batches(150, 256):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.05


@pytest.fixture
def one_thread():
    """One intra-op thread: a wall-clock test must not time the spinning of
    idle threads while other test processes load the host."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def test_watchdog_flags_straggler(one_thread):
    opt = topt.adagrad(1e-2)
    state = tloop.init_state(tdlrm.dlrm_init(CFG, torch.Generator().manual_seed(0), "cpu"), opt)
    batches = _ref_batches(12, 32)
    tr = tloop.Trainer(tloop.make_train_step(_loss_fn, opt),
                       tloop.TrainConfig(num_steps=12, watchdog_factor=2.5),
                       batch_at=batches.__getitem__)
    orig_step = tr.train_step

    def slow_step(state, batch):
        if int(state["step"]) == 9:
            time.sleep(1.0)  # injected straggler
        return orig_step(state, batch)

    tr.train_step = slow_step
    tr.run(state)
    assert any(step == 9 for step, _ in tr.straggler_events)


def test_trainer_refuses_what_is_not_ported():
    """``Trainer(step_wire=)`` is ported: with ``obs`` it counts each leaf's
    accounted bytes per step (and a report's remainder as ``_other``); an
    FSDP step's price, with its parameter gathers, is counted the same
    way."""
    from repro_torch import obs as tobs
    from repro_torch.dist import AUTO, accounting
    step = tloop.make_train_step(_loss_fn, topt.adagrad(1e-2))
    params = tdlrm.dlrm_init(CFG, torch.Generator().manual_seed(0), "cpu")
    report = accounting.dp_step_wire_bytes(params, AUTO, 4, scalar_allreduces=3)
    report["per_leaf"] = accounting.grad_wire_bytes(params, AUTO, 4)["per_leaf"]
    obs = tobs.Obs()
    batches = _ref_batches(3, 16)
    tloop.Trainer(step, tloop.TrainConfig(num_steps=3), batch_at=batches.__getitem__, obs=obs,
                  step_wire=report).run(tloop.init_state(params, topt.adagrad(1e-2)))
    got = {s["labels"]["leaf"]: s["value"]
           for s in obs.registry.snapshot()["train_wire_bytes_total"]["series"]}
    want = {e["path"]: 3 * e["wire_bytes"] for e in report["per_leaf"]}
    want["_other"] = 3 * report["overhead_bytes"]
    assert got == pytest.approx(want, rel=1e-12)
    # without obs the counters cost nothing and nothing is counted
    tloop.Trainer(step, tloop.TrainConfig(num_steps=1), batch_at=batches.__getitem__,
                  step_wire=report).run(tloop.init_state(params, topt.adagrad(1e-2)))
    fsdp = accounting.fsdp_step_wire_bytes(params, topt.adagrad(1e-2), 4, AUTO,
                                           scalar_allreduces=3)
    obs = tobs.Obs()
    tloop.Trainer(step, tloop.TrainConfig(num_steps=2), batch_at=batches.__getitem__, obs=obs,
                  step_wire=fsdp).run(tloop.init_state(params, topt.adagrad(1e-2)))
    got = sum(s["value"] for s in obs.registry.snapshot()["train_wire_bytes_total"]["series"])
    assert fsdp["param_gather_bytes"] > 0
    assert got == pytest.approx(2 * fsdp["total_bytes"], rel=1e-12)


# ------------------------------------------------------- loader and config api


def test_loader_prefetches_in_order_and_seeks():
    calls = []

    def batch_at(step):
        calls.append(step)
        return {"x": torch.full((4, 2), float(step)), "y": torch.arange(4) + step}

    loader = ShardedLoader(batch_at, device="cpu", depth=3)
    try:
        got = [int(next(loader)["x"][0, 0]) for _ in range(5)]
        assert got == [0, 1, 2, 3, 4]
        deadline = time.monotonic() + 10
        while max(calls) < 7 and time.monotonic() < deadline:   # runs ahead by depth
            time.sleep(0.01)
        assert max(calls) >= 7
        loader.seek(42)
        assert [int(next(loader)["y"][0]) for _ in range(3)] == [42, 43, 44]
        loader.seek(3)
        batch = next(loader)
        assert torch.equal(batch["x"], torch.full((4, 2), 3.0))
    finally:
        loader.close()
    assert loader._thread is None


@pytest.mark.parametrize("arch", ["dlrm", "dcn"])
def test_api_optimizer_and_train_batch_follow_reference(arch):
    from repro.configs import dcn_criteo as jdcn_criteo
    jmod, tmod = {"dlrm": (jcriteo, dlrm_criteo), "dcn": (jdcn_criteo, dcn_criteo)}[arch]
    japi = jmod.api(jmod.config(reduced=True))
    tapi = tmod.api(tmod.config(reduced=True), device="cpu")
    jb, tb = japi.train_batch(JShape("t", 1, 64, "train")), tapi.train_batch(
        Shape("t", 1, 64, "train"))
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].device.type == "meta" and tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype) == f"torch.{jb[k].dtype}"
    tparams = tapi.init(torch.Generator().manual_seed(0))
    jparams = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
    want = jopt.state_structs(japi.optimizer, jparams)
    got = topt.state_structs(tapi.optimizer, tparams)
    assert [{k: tuple(v.shape) for k, v in s.items()} for s in got] \
        == [{k: tuple(v.shape) for k, v in s.items()} for s in want]
    # a memory plan solved for other tables is refused
    plan = uniform_hash_plan([power_law_stats(n) for n in (10, 20)], 16, 10 ** 6)
    with pytest.raises(ValueError, match="table sizes"):
        tmod.config(reduced=True, plan=plan)


def test_reduced_config_trains_on_the_cpu():
    """The README's recipe: the reduced DLRM-Criteo through ``Trainer`` with
    ``device="cpu"``, ``api.optimizer`` (Adagrad) on ``api.batch_fn``: finite
    losses, and the step counter advances."""
    api = dlrm_criteo.api(dlrm_criteo.config(reduced=True), device="cpu")
    shape = Shape("train", 1, 64, "train")
    state = tloop.init_state(api.init(torch.Generator().manual_seed(0)), api.optimizer)
    tr = tloop.Trainer(tloop.make_train_step(api.loss_fn, api.optimizer),
                       tloop.TrainConfig(num_steps=8, log_every=2),
                       batch_at=lambda s: api.batch_fn(s, shape))
    state, history = tr.run(state)
    assert int(state["step"]) == 8 and [s for s, _ in history] == [0, 2, 4, 6, 7]
    assert all(np.isfinite(loss) for _, loss in history)


def test_a_step_frees_what_it_drops_without_the_garbage_collector():
    """A train step and the tree walks hold no reference cycle: the old
    state is freed by reference counting alone once the caller drops it
    (a cycle would keep a whole parameter tree of device memory alive until
    the cyclic collector ran)."""
    import gc
    import weakref

    _, tcfg = _cfgs(KINDS["qr_mult"])
    opt = topt.adagrad(1e-2)
    step = tloop.make_train_step(lambda p, b: tdlrm.dlrm_loss_fn(p, b, tcfg), opt)
    state = tloop.init_state(tdlrm.dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu"),
                             opt)
    batch = _tb(_np_batch(seed=7))
    refs = [weakref.ref(x) for x in tree.leaves(state)]
    gc.collect()
    gc.disable()
    try:
        state, _ = step(state, batch)
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
