"""The port's FSDP path in a gloo world of 8 processes, held against the
JAX package's 8-device ``shard_map`` on the same inputs.

One gloo world (``repro_torch.dist.world.spawn``) and one JAX subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before
``import jax``, as ``tests/test_dist.py`` runs its 8-device cases) run
every case once, in a module-scoped fixture, side by side; a second gloo
world of 4 restores the checkpoint the world of 8 wrote.  The config is
the reference's FSDP test's: ``CriteoSpec(table_sizes=(100, 5000, 33))``,
QR with c=4 above a threshold of 50, Adagrad 1e-2, global batch 64.
This file imports no JAX itself.

* ``_reduce_scatter_leaf`` per mode on per-rank gradients and residuals,
  scatter dims 0, 1 and 2: the shards bit-equal for ``int8`` and ``bf16``
  (both sum in a fixed order in f32, int32 for int8; the scale is the
  compiled reference's ``amax · (1/127)``), within 1e-6 of each shard's
  largest |value| for ``none`` (XLA's reduce-scatter sums in its own
  order, the port in rank order); the residuals bit-equal for every mode
  (``int8``'s ``v - q·scale`` rounded once, as XLA's fused multiply-add
  rounds it); the bytes ``dist.wire`` recorded
  equal ``accounting.leaf_reduce_bytes(pattern="reduce_scatter")``;
* ``make_fsdp_train_step`` for 8 steps per policy (none, bf16, int8,
  auto, and auto with the bf16 parameter gather), twice:
  - on a **linear loss** (each parameter leaf times the rank's own fixed
    coefficients, picked by an index in its block of the batch): a leaf's
    gradient is its coefficients exactly, with no product that XLA could
    fuse into the error-feedback add, so the step's own machinery
    (compression, reduce-scatter, Adagrad on the shards, the gather, error
    feedback) is compared on identical inputs — parameters within 1e-6 of
    each leaf's largest |param| after 8 steps, the bf16 gather included
    (finding 1 of the reference: its bf16-gather step is held to its own
    bf16-gather step, not to DP);
  - on the **DLRM loss**: the per-rank backward differs from JAX's in f32
    summation order, and Adagrad's sign-like first step turns a
    roundoff-sized gradient into a ±lr move, so free-running trajectories
    split (``tests/test_torch_dist_world.py``); held as the DP step is
    held there — step 0's loss within rtol 1e-5, step 0's reduced
    gradients (read from Adagrad's accumulator) within 1e-5 of each leaf's
    largest (``none``) or two quantization steps (compressed), later
    losses within rtol 1e-3 (one bf16 step, 2^-8, with the bf16 gather:
    ``BF16_GATHER_LOSS_RTOL``) — and the replicas bitwise equal after every
    step (for the bf16 gather: equal once every scattered leaf is rounded
    to bf16, since each rank keeps its own shard exact), the recorded
    bytes per step equal ``fsdp_step_wire_bytes(..., scalar_allreduces=3)``
    and each rank's optimizer state holding 1/8 of each scattered leaf;
* a checkpoint of the auto-policy state written at step 4
  (``gather_fsdp_state`` by every rank, saved by rank 0) and restored at
  world 8 is the live state bit for bit, and 4 more steps from it end
  where the uninterrupted run ended, bit for bit; restored in a world of
  4 (the elastic restore), each rank's leaves equal the full leaves cut
  by ``fsdp_state_shardings``;
* ``host_slice`` and ``ShardedLoader`` hand each rank its rows.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.convert import state_to_numpy
from repro_torch.core import EmbeddingSpec
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.dist import AUTO, accounting, world
from repro_torch.models.dlrm import DLRMConfig, dlrm_init
from repro_torch.optim.optimizers import adagrad

ROOT = Path(__file__).resolve().parents[1]
N = 8
MODES = ("none", "bf16", "int8")
# (policy, parameter gather dtype): the lanes of the step
LANES = (("none", "float32"), ("bf16", "float32"), ("int8", "float32"), ("auto", "float32"),
         ("auto", "bfloat16"))
STEPS = 8
BATCH = 64
CKPT_STEP = 4
# reduce-scatter cases: (shape, dim), every scattered dim divisible by 8
RS_CASES = (((64, 16), 0), ((24, 40), 1), ((3, 5, 16), 2), ((4096,), 0))
# the bf16-gather lane's later DLRM losses: each rank's forward reads the
# other ranks' shards rounded to bf16, so a parameter one f32 ulp apart can
# land one bf16 step (2^-8 relative) apart in a remote copy; the loss is
# held within one bf16 step (measured: 1.1e-3 at step 7)
BF16_GATHER_LOSS_RTOL = 2.0 ** -8
SPEC = CriteoSpec(table_sizes=(100, 5000, 33))
CFG = DLRMConfig(table_sizes=SPEC.table_sizes,
                 embedding=EmbeddingSpec(kind="qr", num_collisions=4, threshold=50))


def _lane(pol, gd):
    return f"{pol}_{gd}"


def _like():
    return dlrm_init(CFG, torch.Generator().manual_seed(0), "cpu")


def _inputs(path):
    """Every case's numpy inputs, drawn from one seed, in one npz."""
    rng = np.random.default_rng(0)
    arrays = {}
    for mode in MODES:
        for i, (shape, _) in enumerate(RS_CASES):
            arrays[f"rs_g/{mode}/{i}"] = (rng.standard_normal((N,) + shape)
                                          * 10.0 ** -(i + 1)).astype(np.float32)
            arrays[f"rs_e/{mode}/{i}"] = (
                np.zeros((N,), np.float32) if mode == "none" else
                (rng.standard_normal((N,) + shape) * 10.0 ** -(i + 3)).astype(np.float32))
    for i, leaf in enumerate(tree.leaves(state_to_numpy(_like()))):
        arrays[f"param/{i}"] = leaf
        arrays[f"coef/{i}"] = rng.standard_normal((N,) + leaf.shape).astype(np.float32)
    for s in range(STEPS):
        for k, v in batch_at(0, s, BATCH, SPEC, device="cpu").items():
            arrays[f"batch/{s}/{k}"] = v.numpy()
        # the rank each row's block belongs to: the linear loss's coefficient index
        arrays[f"batch/{s}/k"] = np.repeat(np.arange(N, dtype=np.int32), BATCH // N)
    np.savez(path, **arrays)


def _batch(d, s, keys=("dense", "sparse", "label")):
    return {k: torch.from_numpy(d[f"batch/{s}/{k}"].copy()) for k in keys}


def _linear_loss(coefs):
    """Σ_leaves Σ(p · c[k]), ``k`` the index in the rank's block of the
    batch: the gradient of a leaf is ``c[k]``, exactly."""
    def loss_fn(params, batch):
        k = batch["k"][0]
        return sum(torch.sum(p * c[k]) for p, c in zip(tree.leaves(params), coefs)), {}
    return loss_fn


def _checksum(params, bf16_scattered=None):
    """Per leaf: the sum of the f32 bit patterns, plain and weighted by
    position (int64); with ``bf16_scattered`` (a flag per leaf) those
    leaves are rounded to bf16 first."""
    out = []
    for i, p in enumerate(tree.leaves(params)):
        if bf16_scattered is not None and bf16_scattered[i]:
            p = p.to(torch.bfloat16).to(torch.float32)
        bits = p.reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), dtype=torch.int64) % 65521 + 1
        out += [int(bits.sum()), int((bits * w).sum())]
    return out


def _torch_world(rank, world_size, inputs, out_dir):
    """One rank of the gloo world: every case, results to ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.loader import ShardedLoader, host_slice
    from repro_torch.dist import compress, wire
    from repro_torch.train.loop import (fsdp_state_shardings, gather_fsdp_state,
                                        init_fsdp_state, make_fsdp_train_step)

    torch.set_num_threads(1)
    d = np.load(inputs)
    res = {}
    for mode in MODES:
        for i, (shape, dim) in enumerate(RS_CASES):
            g = torch.from_numpy(d[f"rs_g/{mode}/{i}"][rank].copy())
            e = torch.from_numpy(np.array(d[f"rs_e/{mode}/{i}"][rank]))
            wire.reset()
            shard, ne = compress._reduce_scatter_leaf(g, e, dist.group.WORLD, mode, dim,
                                                      leaf="x")
            res[f"rs_out/{mode}/{i}"] = shard.numpy()
            res[f"rs_err/{mode}/{i}"] = ne.numpy()
            res[f"rs_wire/{mode}/{i}"] = np.array(wire.snapshot()["total_bytes"])

    like = _like()
    n_leaves = len(tree.leaves(like))
    params = tree.unflatten(like, [torch.from_numpy(d[f"param/{i}"].copy())
                                   for i in range(n_leaves)])
    coefs = [torch.from_numpy(d[f"coef/{i}"].copy()) for i in range(n_leaves)]
    opt = adagrad(1e-2)
    from repro_torch.models.dlrm import dlrm_loss_fn

    def dlrm_loss(p, b):
        return dlrm_loss_fn(p, b, CFG)

    for pol, gd in LANES:
        lane = _lane(pol, gd)
        step = make_fsdp_train_step(dlrm_loss, opt, None, params, policy=pol,
                                    param_gather_dtype=gd)
        scattered = [dim is not None for (_, _, _, dim) in step.plan]
        state = init_fsdp_state(params, opt, policy=pol)
        res[f"opt_numel/{lane}"] = np.array([sum(x.numel() for x in tree.leaves(o))
                                             for o in state["opt"]])
        sums = []
        ckpt_lane = pol == "auto" and gd == "float32"
        rec, rec_steps = None, 0
        for s in range(STEPS):
            state, m = step(state, _batch(d, s))
            res[f"dlrm/{lane}/loss/{s}"] = m["loss"].numpy()
            sums.append(_checksum(state["params"], scattered if gd == "bfloat16" else None))
            if s == 0:
                full = gather_fsdp_state(state, step.plan)
                for i, o in enumerate(full["opt"]):
                    res[f"dlrm/{lane}/acc0/{i}"] = o["acc"].numpy()
                wire.reset()                # steps 1.. are counted
            elif rec is None:
                rec_steps += 1
            if ckpt_lane and s == CKPT_STEP - 1:
                rec = wire.snapshot()["total_bytes"]
                full = gather_fsdp_state(state, step.plan)
                if rank == 0:
                    ckpt.save(os.path.join(out_dir, "ckpt"), CKPT_STEP, full)
                dist.barrier()
                resumed, _ = ckpt.restore(os.path.join(out_dir, "ckpt"), CKPT_STEP, state,
                                          shardings=fsdp_state_shardings(
                                              state, step.plan, rank, world_size))
                res["ckpt/restored_equal"] = np.array(all(
                    torch.equal(a, b) for a, b in zip(tree.leaves(resumed),
                                                      tree.leaves(state))))
            elif ckpt_lane and s >= CKPT_STEP:
                resumed, _ = step(resumed, _batch(d, s))
        if rec is None:
            rec = wire.snapshot()["total_bytes"]
        res[f"dlrm/{lane}/wire_per_step"] = np.array(rec / rec_steps)
        res[f"dlrm/{lane}/checksums"] = np.array(sums)
        if ckpt_lane:
            res["ckpt/resumed_equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(tree.leaves(resumed["params"]),
                                                  tree.leaves(state["params"]))))
        for i, p in enumerate(tree.leaves(state["params"])):
            res[f"dlrm/{lane}/params/{i}"] = p.numpy()

        step = make_fsdp_train_step(_linear_loss(coefs), opt, None, params, policy=pol,
                                    param_gather_dtype=gd)
        state = init_fsdp_state(params, opt, policy=pol)
        for s in range(STEPS):
            state, _ = step(state, _batch(d, s, ("k",)))
        for i, p in enumerate(tree.leaves(state["params"])):
            res[f"lin/{lane}/params/{i}"] = p.numpy()

    batch = _batch(d, 0)
    res["host_slice"] = host_slice(batch)["sparse"].numpy()
    loader = ShardedLoader(lambda s: _batch(d, s), depth=1)
    res["loader"] = np.stack([next(loader)["label"].numpy() for _ in range(2)])
    loader.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def _torch_world_of_4(rank, world_size, inputs, out_dir):
    """The elastic restore: the world of 8's checkpoint onto 4 ranks."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.train.loop import fsdp_plan, fsdp_state_shardings, init_fsdp_state

    torch.set_num_threads(1)
    d = np.load(inputs)
    like = _like()
    params = tree.unflatten(like, [torch.from_numpy(d[f"param/{i}"].copy())
                                   for i in range(len(tree.leaves(like)))])
    opt = adagrad(1e-2)
    state = init_fsdp_state(params, opt, policy="auto")
    plan = fsdp_plan(params, opt, world_size, policy="auto")
    shardings = fsdp_state_shardings(state, plan, rank, world_size)
    restored, _ = ckpt.restore(os.path.join(out_dir, "ckpt"), CKPT_STEP, state,
                               shardings=shardings)
    full, _ = ckpt.restore(os.path.join(out_dir, "ckpt"), CKPT_STEP, state)
    res = {"equal": np.array(all(torch.equal(r, s.take(f)) for r, s, f in zip(
        tree.leaves(restored), tree.leaves(shardings), tree.leaves(full)))),
        "err_rows": np.array([tuple(e.shape)[0] for e in tree.leaves(restored["err"])]),
        "cut": np.array(sum(s.count > 1 for s in tree.leaves(shardings)))}
    np.savez(os.path.join(out_dir, f"four{rank}.npz"), **res)


_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core import EmbeddingSpec
    from repro.data.criteo import CriteoSpec
    from repro.dist.compress import _reduce_scatter_leaf
    from repro.models.dlrm import DLRMConfig, dlrm_init, dlrm_loss_fn
    from repro.optim.optimizers import adagrad
    from repro.train.loop import init_fsdp_state, make_fsdp_train_step

    MODES, LANES, STEPS, RS_CASES = {modes!r}, {lanes!r}, {steps}, {rs_cases!r}
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((8,), ("data",))
    res = {{}}
    for mode in MODES:
        for i, (shape, dim) in enumerate(RS_CASES):
            def body(g, e, mode=mode, dim=dim):
                shard, ne = _reduce_scatter_leaf(g[0], e[0], "data", mode, dim)
                return shard[None], ne[None]
            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                                   out_specs=(P("data"), P("data")), check_rep=False))
            out, ne = fn(jnp.asarray(d[f"rs_g/{{mode}}/{{i}}"]),
                         jnp.asarray(d[f"rs_e/{{mode}}/{{i}}"]))
            res[f"rs_out/{{mode}}/{{i}}"] = np.asarray(out)
            res[f"rs_err/{{mode}}/{{i}}"] = np.asarray(ne)

    spec = CriteoSpec(table_sizes=(100, 5000, 33))
    cfg = DLRMConfig(table_sizes=spec.table_sizes,
                     embedding=EmbeddingSpec(kind="qr", num_collisions=4, threshold=50))
    treedef = jax.tree.structure(jax.eval_shape(lambda k: dlrm_init(k, cfg),
                                                jax.random.PRNGKey(0)))
    params = jax.tree.unflatten(
        treedef, [jnp.asarray(d[f"param/{{i}}"]) for i in range(treedef.num_leaves)])
    coefs = [jnp.asarray(d[f"coef/{{i}}"]) for i in range(treedef.num_leaves)]
    opt = adagrad(1e-2)

    def linear_loss(p, b):
        k = b["k"][0]
        return sum(jnp.sum(x * c[k]) for x, c in zip(jax.tree.leaves(p), coefs)), {{}}

    for pol, gd in LANES:
        lane = f"{{pol}}_{{gd}}"
        for name, loss_fn, keys in (
                ("dlrm", lambda p, b: dlrm_loss_fn(p, b, cfg), ("dense", "sparse", "label")),
                ("lin", linear_loss, ("k",))):
            state = init_fsdp_state(params, opt, mesh, policy=pol)
            step = jax.jit(make_fsdp_train_step(loss_fn, opt, mesh, params, policy=pol,
                                                param_gather_dtype=gd))
            with mesh:
                for s in range(STEPS):
                    batch = {{k: jnp.asarray(d[f"batch/{{s}}/{{k}}"]) for k in keys}}
                    state, metrics = step(state, batch)
                    if name == "dlrm":
                        res[f"dlrm/{{lane}}/loss/{{s}}"] = np.asarray(metrics["loss"])
                        if s == 0:
                            for i, o in enumerate(state["opt"]):
                                res[f"dlrm/{{lane}}/acc0/{{i}}"] = np.asarray(o["acc"])
            for i, p in enumerate(jax.tree.leaves(state["params"])):
                res[f"{{name}}/{{lane}}/params/{{i}}"] = np.asarray(p)
    np.savez(sys.argv[2], **res)
""").format(modes=MODES, lanes=LANES, steps=STEPS, rs_cases=RS_CASES)


@pytest.fixture(scope="module")
def runs():
    """The inputs and both sides' results: ``(inputs, jax, [rank 0 .. 7],
    [rank 0 .. 3 of the world of 4])``."""
    with tempfile.TemporaryDirectory(prefix="test_torch_fsdp_world_") as d:
        inputs = os.path.join(d, "inputs.npz")
        _inputs(inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        ref = subprocess.Popen([sys.executable, "-c", _JAX, inputs, os.path.join(d, "jax.npz")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        try:
            world.spawn(_torch_world, N, "gloo", inputs, d)
            world.spawn(_torch_world_of_4, 4, "gloo", inputs, d)
        finally:
            _, err = ref.communicate(timeout=900)
        assert ref.returncode == 0, err[-3000:]
        jres = dict(np.load(os.path.join(d, "jax.npz")))
        ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(N)]
        fours = [dict(np.load(os.path.join(d, f"four{r}.npz"))) for r in range(4)]
        yield dict(np.load(inputs)), jres, ranks, fours


@pytest.mark.parametrize("mode", MODES)
def test_reduce_scatter_matches_shard_map(runs, mode):
    _, jres, ranks, _ = runs
    for i, (shape, dim) in enumerate(RS_CASES):
        for r, res in enumerate(ranks):
            out, want = res[f"rs_out/{mode}/{i}"], jres[f"rs_out/{mode}/{i}"][r]
            assert out.shape == want.shape
            if mode == "none":
                np.testing.assert_allclose(out, want, rtol=0,
                                           atol=1e-6 * float(np.abs(want).max()))
            else:
                np.testing.assert_array_equal(out, want)
            np.testing.assert_array_equal(res[f"rs_err/{mode}/{i}"],
                                          jres[f"rs_err/{mode}/{i}"][r])
            nbytes = 4 * int(np.prod(shape))
            want_bytes = accounting.leaf_reduce_bytes(mode, nbytes // 4, N,
                                                      pattern="reduce_scatter")
            assert float(res[f"rs_wire/{mode}/{i}"]) == want_bytes


@pytest.mark.parametrize("pol,gd", LANES)
def test_fsdp_step_on_a_linear_loss_matches_the_reference(runs, pol, gd):
    """Identical gradients in both packages: after 8 steps every parameter
    within 1e-6 of its leaf's largest |param| (Adagrad's ``acc + g²``,
    which XLA may fuse, and ``none``'s summation order are the only
    roundings apart)."""
    _, jres, ranks, _ = runs
    lane = _lane(pol, gd)
    worst = 0.0
    n_leaves = sum(k.startswith(f"lin/{lane}/params/") for k in ranks[0])
    for i in range(n_leaves):
        got, want = ranks[0][f"lin/{lane}/params/{i}"], jres[f"lin/{lane}/params/{i}"]
        scale = float(np.abs(want).max())
        d = float(np.abs(got - want).max())
        worst = max(worst, d / scale)
        assert d <= 1e-6 * scale, (i, d, scale)
    print(f"{lane}: worst leaf {worst:.3e} of its largest |param|")


@pytest.mark.parametrize("pol,gd", LANES)
def test_fsdp_step_on_dlrm_tracks_the_reference(runs, pol, gd):
    """The DLRM loss: step 0's loss and reduced gradients, later losses
    (tolerances in the module docstring)."""
    from repro_torch.dist import resolve_modes
    _, jres, ranks, _ = runs
    lane = _lane(pol, gd)
    res = ranks[0]
    np.testing.assert_allclose(res[f"dlrm/{lane}/loss/0"], jres[f"dlrm/{lane}/loss/0"],
                               rtol=1e-5)
    modes = resolve_modes(_like(), AUTO if pol == "auto" else pol)
    for i, mode in enumerate(modes):
        g, jg = np.sqrt(res[f"dlrm/{lane}/acc0/{i}"]), np.sqrt(jres[f"dlrm/{lane}/acc0/{i}"])
        big = float(jg.max())
        step = {"none": 0.0, "bf16": 2.0 ** -8, "int8": 1.0 / 127}[mode]
        np.testing.assert_allclose(g, jg, rtol=0, atol=max(1e-5, 2 * step) * big + 1e-12)
    rtol = BF16_GATHER_LOSS_RTOL if gd == "bfloat16" else 1e-3
    for s in range(1, STEPS):
        np.testing.assert_allclose(res[f"dlrm/{lane}/loss/{s}"], jres[f"dlrm/{lane}/loss/{s}"],
                                   rtol=rtol)


@pytest.mark.parametrize("pol,gd", LANES)
def test_fsdp_replicas_wire_and_optimizer_shards(runs, pol, gd):
    _, _, ranks, _ = runs
    lane = _lane(pol, gd)
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[f"dlrm/{lane}/checksums"],
                                      ranks[0][f"dlrm/{lane}/checksums"])
    like = _like()
    p = AUTO if pol == "auto" else pol
    want = accounting.fsdp_step_wire_bytes(like, adagrad(1e-2), N, p, scalar_allreduces=3,
                                           param_gather_dtype=gd)
    assert want["n_scattered"] > 0
    assert float(ranks[0][f"dlrm/{lane}/wire_per_step"]) == pytest.approx(
        want["total_bytes"], rel=1e-12)
    from repro_torch.train.loop import fsdp_plan
    plan = fsdp_plan(like, adagrad(1e-2), N, policy=pol)
    for (_, shape, _, dim), numel in zip(plan, ranks[0][f"opt_numel/{lane}"]):
        assert numel == (int(np.prod(shape)) // N if dim is not None else int(np.prod(shape)))


def test_fsdp_checkpoint_restart_and_elastic_restore(runs):
    _, _, ranks, fours = runs
    for res in ranks:
        assert bool(res["ckpt/restored_equal"]) and bool(res["ckpt/resumed_equal"])
    for res in fours:
        assert bool(res["equal"]) and int(res["cut"]) > 0
        assert set(res["err_rows"].tolist()) == {N // 4}


def test_host_slice_and_the_loader_hand_each_rank_its_rows(runs):
    inputs, _, ranks, _ = runs
    per = BATCH // N
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["host_slice"],
                                      inputs["batch/0/sparse"][r * per:(r + 1) * per])
        for s in range(2):
            np.testing.assert_array_equal(res["loader"][s],
                                          inputs[f"batch/{s}/label"][r * per:(r + 1) * per])

