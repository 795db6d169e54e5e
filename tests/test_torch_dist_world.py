"""The port's data-parallel path in a gloo world of 8 processes, held
against the JAX package's 8-device ``shard_map`` on the same inputs.

One gloo world (``repro_torch.dist.world.spawn``) and one JAX subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before
``import jax``, as ``tests/test_dist.py`` runs its 8-device cases) run
every case once, in a module-scoped fixture, side by side; the tests
compare what they saved.  This file imports no JAX itself.

* ``ef_psum_grads`` on identical per-rank gradients and residuals, three
  independent calls per mode: the reduced gradients bit-equal for
  ``int8`` and ``bf16`` (both sum in a fixed order in f32, int32 for
  int8; the scale is the compiled reference's ``amax · (1/127)``), within
  1e-6 of each leaf's largest |value| for ``none`` (an all-reduce whose
  order the backend picks); the new residuals bit-equal for ``bf16``, and
  for ``int8`` equal outside the rank's own shard and within ``n`` f32
  ulps of the leaf's largest |v| inside it: there the two-level correction
  ``v - (q·scale - n·(y - q2·scale2))`` is a difference of near-equal
  values, which XLA compiles with fused multiply-adds and the port rounds
  product by product;
* the bytes ``dist.wire`` recorded for each call equal
  ``accounting.grad_wire_bytes``, leaf by leaf;
* error feedback's time-averaged output over 30 steps equals the true
  mean within the EF envelope, on every replica identically (the
  property of ``tests/test_dist.py::test_ef_psum_unbiased_over_time_8dev_shard_map``);
* ``make_dp_train_step`` on the reduced DLRM-Criteo for 3 steps per
  policy from the port's CPU-drawn parameters and batches (tolerances at
  ``test_dp_step_tracks_the_reference``), replicas bitwise identical and
  the recorded bytes per step equal to ``dp_step_wire_bytes``.
"""

import json
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
from repro_torch.configs import dlrm_criteo
from repro_torch.convert import state_to_numpy
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.dist import AUTO, accounting, resolve_modes, world

ROOT = Path(__file__).resolve().parents[1]
N = 8
MODES = ("none", "bf16", "int8")
POLICIES = ("none", "bf16", "int8", "auto")
CALLS = 3
EF_STEPS = 30
EF_DIM = 64
DP_STEPS = 3
DP_BATCH = 64
# a tree with a leaf whose size no world divides (padding) and a small one
EF_SHAPES = {"b": (9,), "tables": [(333, 16)], "w": (77, 5)}


def _leaf_shapes():
    """EF_SHAPES' leaves in leaf order: b, tables/0, w."""
    return [EF_SHAPES["b"], EF_SHAPES["tables"][0], EF_SHAPES["w"]]


def _ef_like():
    return {"b": torch.empty(EF_SHAPES["b"]), "tables": [torch.empty(EF_SHAPES["tables"][0])],
            "w": torch.empty(EF_SHAPES["w"])}


def _inputs(path):
    """Every case's numpy inputs, drawn from one seed, in one npz."""
    rng = np.random.default_rng(0)
    arrays = {}
    for mode in MODES:
        for c in range(CALLS):
            for i, shape in enumerate(_leaf_shapes()):
                arrays[f"g/{mode}/{c}/{i}"] = (rng.standard_normal((N,) + shape)
                                               * 10.0 ** -(i + 1)).astype(np.float32)
                arrays[f"e/{mode}/{c}/{i}"] = (
                    np.zeros((N,), np.float32) if mode == "none" else
                    (rng.standard_normal((N,) + shape) * 10.0 ** -(i + 3)).astype(np.float32))
    arrays["bias_g"] = (rng.standard_normal((N, EF_DIM)) * 3e-3
                        + np.linspace(-1e-3, 1e-3, N)[:, None]).astype(np.float32)
    cfg = dlrm_criteo.config(reduced=True)
    api = dlrm_criteo.api(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    for i, leaf in enumerate(tree.leaves(state_to_numpy(params))):
        arrays[f"param/{i}"] = leaf
    spec = CriteoSpec(table_sizes=cfg.table_sizes, zipf=1.5, noise=0.5)
    for s in range(DP_STEPS):
        for k, v in batch_at(0, s, DP_BATCH, spec, device="cpu").items():
            arrays[f"batch/{s}/{k}"] = v.numpy()
    np.savez(path, **arrays)


def _torch_world(rank, world_size, inputs, out_dir):
    """One rank of the gloo world: every case, results to ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.dist import compress, wire
    from repro_torch.train.loop import init_dp_state, make_dp_train_step

    torch.set_num_threads(1)
    d = np.load(inputs)
    res = {}

    def leaf_tree(prefix, mode, c):
        ls = [torch.from_numpy(np.array(d[f"{prefix}/{mode}/{c}/{i}"][rank]))
              for i in range(3)]
        return {"b": ls[0], "tables": [ls[1]], "w": ls[2]}

    for mode in MODES:
        for c in range(CALLS):
            g, e = leaf_tree("g", mode, c), leaf_tree("e", mode, c)
            wire.reset()
            out, new_e = compress.ef_psum_grads(g, e, group=dist.group.WORLD, mode=mode)
            snap = wire.snapshot()
            for i, (o, ne) in enumerate(zip(tree.leaves(out), tree.leaves(new_e))):
                res[f"out/{mode}/{c}/{i}"] = o.numpy()
                res[f"err/{mode}/{c}/{i}"] = ne.numpy()
            res[f"wire/{mode}/{c}"] = np.array(json.dumps(snap))

    g = {"w": torch.from_numpy(d["bias_g"][rank].copy())}
    for mode in ("bf16", "int8"):
        err = compress.init_error_state(g, mode)
        total = torch.zeros(EF_DIM)
        for _ in range(EF_STEPS):
            out, err = compress.ef_psum_grads(g, err, group=dist.group.WORLD, mode=mode)
            total = total + out["w"]
        res[f"bias_total/{mode}"] = total.numpy()

    cfg = dlrm_criteo.config(reduced=True)
    api = dlrm_criteo.api(cfg, device="cpu")
    like = api.init(torch.Generator().manual_seed(0))
    n_leaves = len(tree.leaves(like))
    for pol in POLICIES:
        params = tree.unflatten(like, [torch.from_numpy(d[f"param/{i}"].copy())
                                       for i in range(n_leaves)])
        state = init_dp_state(params, api.optimizer, compress=pol)
        step = make_dp_train_step(api.loss_fn, api.optimizer, compress=pol)
        wire.reset()
        for s in range(DP_STEPS):
            batch = {k: torch.from_numpy(d[f"batch/{s}/{k}"].copy())
                     for k in ("dense", "sparse", "label")}
            state, metrics = step(state, batch)
            res[f"dp/{pol}/loss/{s}"] = metrics["loss"].numpy()
            if s == 0:
                for i, o in enumerate(state["opt"]):
                    res[f"dp/{pol}/acc0/{i}"] = o["acc"].numpy()
        for i, p in enumerate(tree.leaves(state["params"])):
            res[f"dp/{pol}/params/{i}"] = p.numpy()
        res[f"dp/{pol}/wire"] = np.array(json.dumps(wire.snapshot()))
    try:                                    # a global batch no world of 8 splits
        step(state, {k: torch.from_numpy(d[f"batch/0/{k}"][:DP_BATCH - 1].copy())
                     for k in ("dense", "sparse", "label")})
    except ValueError as e:
        res["dp/refused"] = np.array(str(e))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.configs import dlrm_criteo
    from repro.dist.compress import ef_psum_grads
    from repro.train.loop import init_dp_state, make_dp_train_step

    MODES, POLICIES, CALLS, STEPS = {modes!r}, {policies!r}, {calls}, {steps}
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((8,), ("data",))
    res = {{}}

    def local(x):
        return jax.tree.map(lambda a: a[0], x)

    def stacked(x):
        return jax.tree.map(lambda a: a[None], x)

    for mode in MODES:
        def body(g, e, mode=mode):
            out, ne = ef_psum_grads(local(g), local(e), axis_name="data", mode=mode)
            return stacked(out), stacked(ne)
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")), check_rep=False))
        for c in range(CALLS):
            g = [jnp.asarray(d[f"g/{{mode}}/{{c}}/{{i}}"]) for i in range(3)]
            e = [jnp.asarray(d[f"e/{{mode}}/{{c}}/{{i}}"]) for i in range(3)]
            out, ne = fn({{"b": g[0], "tables": [g[1]], "w": g[2]}},
                         {{"b": e[0], "tables": [e[1]], "w": e[2]}})
            for i, (o, n_) in enumerate(zip(jax.tree.leaves(out), jax.tree.leaves(ne))):
                res[f"out/{{mode}}/{{c}}/{{i}}"] = np.asarray(o)
                res[f"err/{{mode}}/{{c}}/{{i}}"] = np.asarray(n_)

    cfg = dlrm_criteo.config(reduced=True)
    api = dlrm_criteo.api(cfg)
    treedef = jax.tree.structure(jax.eval_shape(api.init, jax.random.PRNGKey(0)))
    params = jax.tree.unflatten(
        treedef, [jnp.asarray(d[f"param/{{i}}"]) for i in range(treedef.num_leaves)])
    for pol in POLICIES:
        state = init_dp_state(params, api.optimizer, compress=pol)
        step = jax.jit(make_dp_train_step(api.loss_fn, api.optimizer, mesh, compress=pol))
        with mesh:
            for s in range(STEPS):
                batch = {{k: jnp.asarray(d[f"batch/{{s}}/{{k}}"])
                         for k in ("dense", "sparse", "label")}}
                state, metrics = step(state, batch)
                res[f"dp/{{pol}}/loss/{{s}}"] = np.asarray(metrics["loss"])
                if s == 0:
                    for i, o in enumerate(state["opt"]):
                        res[f"dp/{{pol}}/acc0/{{i}}"] = np.asarray(o["acc"])
        for i, p in enumerate(jax.tree.leaves(state["params"])):
            res[f"dp/{{pol}}/params/{{i}}"] = np.asarray(p)
    np.savez(sys.argv[2], **res)
""").format(modes=MODES, policies=POLICIES, calls=CALLS, steps=DP_STEPS)


@pytest.fixture(scope="module")
def runs():
    """The inputs and both sides' results: ``(inputs, jax, [rank 0 .. rank 7])``."""
    with tempfile.TemporaryDirectory(prefix="test_torch_dist_world_") as d:
        inputs = os.path.join(d, "inputs.npz")
        _inputs(inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        ref = subprocess.Popen([sys.executable, "-c", _JAX, inputs, os.path.join(d, "jax.npz")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        try:
            world.spawn(_torch_world, N, "gloo", inputs, d)
        finally:
            _, err = ref.communicate(timeout=600)
        assert ref.returncode == 0, err[-3000:]
        jres = dict(np.load(os.path.join(d, "jax.npz")))
        ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(N)]
        yield dict(np.load(inputs)), jres, ranks


def _shard_slice(numel, rank):
    shard = -(-numel // N)
    return slice(rank * shard, min((rank + 1) * shard, numel))


@pytest.mark.parametrize("mode", MODES)
def test_ef_psum_grads_matches_shard_map(runs, mode):
    inputs, jres, ranks = runs
    differing = total = 0
    for c in range(CALLS):
        for i in range(3):
            for r, res in enumerate(ranks):
                out, want = res[f"out/{mode}/{c}/{i}"], jres[f"out/{mode}/{c}/{i}"][r]
                if mode == "none":
                    np.testing.assert_allclose(out, want, rtol=0,
                                               atol=1e-6 * float(np.abs(want).max()))
                else:
                    np.testing.assert_array_equal(out, want)
                err, jerr = res[f"err/{mode}/{c}/{i}"], jres[f"err/{mode}/{c}/{i}"][r]
                if mode != "int8":
                    np.testing.assert_array_equal(err, jerr)
                    continue
                # outside the rank's own shard: bit-equal; inside it, the
                # two-level correction XLA computes with fused multiply-adds
                flat, jflat = err.reshape(-1), jerr.reshape(-1)
                mine = _shard_slice(flat.size, r)
                rest = np.ones(flat.size, bool)
                rest[mine] = False
                np.testing.assert_array_equal(flat[rest], jflat[rest])
                if rest.all():
                    continue
                # an ulp of the largest |v| = |g + e| of the leaf on any rank
                v = np.abs(inputs[f"g/{mode}/{c}/{i}"] + inputs[f"e/{mode}/{c}/{i}"]).max()
                assert np.abs(flat[mine] - jflat[mine]).max() <= N * np.spacing(v)
                differing += int((flat != jflat).sum())
                total += flat.size
    if mode == "int8":
        print(f"int8 residual elements a few ulps apart at the rank's own shard: {differing} "
              f"of {total}")


@pytest.mark.parametrize("mode", MODES)
def test_recorded_wire_bytes_equal_closed_forms(runs, mode):
    _, _, ranks = runs
    want = accounting.grad_wire_bytes(_ef_like(), mode, N)
    for res in ranks:
        for c in range(CALLS):
            snap = json.loads(str(res[f"wire/{mode}/{c}"]))
            assert snap["total_bytes"] == want["total_bytes"]
            assert snap["per_leaf"] == {e["path"]: e["wire_bytes"] for e in want["per_leaf"]}
    calls = json.loads(str(ranks[0][f"wire/{mode}/0"]))["per_kind"]
    if mode == "none":
        assert calls["all_reduce"]["calls"] == 3 and calls["all_to_all"]["calls"] == 0
    else:
        assert calls["all_to_all"]["calls"] == calls["all_gather"]["calls"] == 3
        assert calls["all_reduce"]["calls"] == (6 if mode == "int8" else 0)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_error_feedback_unbiased_over_time(runs, mode):
    """The reference bounds |average − true mean| by 0.02·scale + 1e-5 over
    60 steps; EF's envelope is the largest residual over T, so over 30
    steps the bound doubles."""
    inputs, _, ranks = runs
    totals = [res[f"bias_total/{mode}"] for res in ranks]
    for t in totals[1:]:
        np.testing.assert_array_equal(t, totals[0])
    true_mean = inputs["bias_g"].mean(axis=0)
    err = float(np.abs(totals[0] / EF_STEPS - true_mean).max())
    scale = float(np.abs(true_mean).max())
    print(f"{mode}: |average - true mean| {err:.3e}, scale {scale:.3e}")
    assert err <= 2 * (0.02 * scale + 1e-5), (err, scale)


def test_dp_step_refuses_a_batch_the_world_does_not_split(runs):
    _, _, ranks = runs
    assert all("does not split over 8 ranks" in str(res["dp/refused"]) for res in ranks)


@pytest.mark.parametrize("pol", POLICIES)
def test_dp_step_replicas_agree_and_wire_matches(runs, pol):
    """After 3 steps every rank holds the same parameters, bit for bit
    (the reference's lock-step property), and the bytes recorded per step
    equal ``dp_step_wire_bytes(..., scalar_allreduces=3)``: the loss and
    the two metrics' means."""
    _, _, ranks = runs
    n_leaves = sum(k.startswith(f"dp/{pol}/params/") for k in ranks[0])
    for i in range(n_leaves):
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[f"dp/{pol}/params/{i}"],
                                          ranks[0][f"dp/{pol}/params/{i}"])
    like = dlrm_criteo.api(dlrm_criteo.config(reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    want = accounting.dp_step_wire_bytes(like, AUTO if pol == "auto" else pol, N,
                                         scalar_allreduces=3)
    snap = json.loads(str(ranks[0][f"dp/{pol}/wire"]))
    assert snap["total_bytes"] == pytest.approx(DP_STEPS * want["total_bytes"], rel=1e-12)
    assert snap["per_leaf"]["_metrics"] == pytest.approx(
        DP_STEPS * want["overhead_bytes"], rel=1e-12)


@pytest.mark.parametrize("pol", POLICIES)
def test_dp_step_tracks_the_reference(runs, pol):
    """The port's DP step against the JAX package's on the same parameters
    and batches.

    * Step 0's loss: the same forward on the same inputs, f32 summation
      order apart — rtol 1e-5 (``tests/test_kernels.py``'s f32 tolerance).
    * Step 0's reduced gradients, read as Adagrad's accumulator (acc = g²
      after one step from zero): ``none`` within 1e-5 of each leaf's
      largest value (f32 order in the per-rank backward and the
      all-reduce); a compressed leaf is quantized from per-rank gradients
      that differ in their last bits, so an element may land one
      quantization step apart (one bf16 ulp, or one int8 step of the
      shared scale per phase) — held to within two steps of each leaf's
      largest |g|, with at most 1% of the elements apart by more than
      1e-5.
    * Steps 1 and 2's losses: after Adagrad's sign-like first step an
      element whose gradient is roundoff-sized moves by up to 2·lr either
      way, so the trajectories split slowly — rtol 1e-3.
    """
    _, jres, ranks = runs
    res = ranks[0]
    np.testing.assert_allclose(res[f"dp/{pol}/loss/0"], jres[f"dp/{pol}/loss/0"], rtol=1e-5)
    like = dlrm_criteo.api(dlrm_criteo.config(reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0))
    modes = resolve_modes(like, AUTO if pol == "auto" else pol)
    apart = total = 0
    for i, mode in enumerate(modes):
        g, jg = np.sqrt(res[f"dp/{pol}/acc0/{i}"]), np.sqrt(jres[f"dp/{pol}/acc0/{i}"])
        big = float(jg.max())
        if mode == "none":
            np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * big)
            continue
        step = 2.0 ** -8 if mode == "bf16" else 1.0 / 127
        np.testing.assert_allclose(g, jg, rtol=0, atol=2 * step * big + 1e-12)
        apart += int((np.abs(g - jg) > 1e-5 * big).sum())
        total += g.size
    if total:
        print(f"{pol}: compressed gradient elements apart by more than 1e-5: {apart} of {total}")
        assert apart <= 0.01 * total
    for s in range(1, DP_STEPS):
        np.testing.assert_allclose(res[f"dp/{pol}/loss/{s}"], jres[f"dp/{pol}/loss/{s}"],
                                   rtol=1e-3)
    print(pol, [float(res[f"dp/{pol}/loss/{s}"]) for s in range(DP_STEPS)],
          [float(jres[f"dp/{pol}/loss/{s}"]) for s in range(DP_STEPS)])
