"""The port's DTensor mapping of the sharding rule engine, held against
the JAX package's GSPMD side.

The reference runs in a subprocess with 8 forced host devices and a mesh
of ``Auto`` axes (jax 0.9's ``make_mesh`` default, ``Explicit``, refuses
``with_sharding_constraint``; ROADMAP §3).  For every parameter leaf of
reduced tinyllama-1.1b, deepseek-v2-236b and mamba2-370m, in training and
under ``INFERENCE_OVERRIDES``, on a ``(data=2, model=4)`` and a
``(pod=2, data=2, model=2)`` mesh:

* the port's spec (``tree_shardings``) equals the reference's
  ``tree_shardings(...)[leaf].spec``;
* at every mesh coordinate, the block the port's placements give
  (``_compute_local_shape_and_global_offset``) equals the reference's
  ``devices_indices_map`` — tuples of axes on one dim included, whatever
  their order against the mesh's (``to_placements``' ``_StridedShard``).

``cache_spec`` and ``_batch_like_spec`` equal the reference's on the
shapes of the reduced caches and batches, ``model_divides`` follows
``set_batch_shard_axes`` as the reference's does, and ``constrain`` is the
identity on plain tensors and redistributes a DTensor in a fake world of 8
(a subprocess: the fake process group belongs to the whole process).

The DTensor paths compute the models' functions: in a gloo world of 4 on
a ``(data=2, model=2)`` mesh, reduced tinyllama-1.1b, deepseek-v2-236b,
mamba2-370m and zamba2-1.2b in f32, laid out as the dry run lays them out
(the inference placement, the prefill cache layout, batch-split tokens),
give the plain model's prefill and decode logits within 1e-5 of their
largest magnitude (split contractions and the split softmax over the
cache sum f32 terms in another order), and tinyllama's, deepseek's and
mamba2's loss and gradients in the training layout likewise; on a
``(data=1, model=4)`` mesh, where tinyllama's 2 kv heads do not split over
4 ranks and each rank takes the one its q heads share, so do tinyllama's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.configs.common import _batch_like_spec, cache_spec
from repro_torch.dist import sharding
from repro_torch.optim.optimizers import leaf_paths

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "deepseek-v2-236b", "mamba2-370m")
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (shape, spec) pairs whose tuples run against the mesh's order, and with it
EXTRA = {"2x4": [((16, 3), (("model", "data"), None)), ((16, 3), (("data", "model"), None))],
         "2x2x2": [((16, 8), (("model", "pod"), "data")), ((8, 16), (None, ("data", "pod"))),
                   ((32, 2), (("model", "data", "pod"), None))]}
CACHE_SHAPES = [(2, 8, 64, 2, 16), (2, 8, 64, 16), (8, 1), (8, 64), (1, 64, 4, 16),
                (2, 1, 512, 16), (4, 6, 8, 8)]

_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import get_arch
    from repro.configs.common import _batch_like_spec, cache_spec
    from repro.dist import sharding
    from repro.optim.optimizers import leaf_paths
    meshes, archs, extra, cache_shapes = json.loads(sys.argv[1])

    def spec_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def blocks(mesh, sh, shape):
        out = {}
        for dev, idx in sh.devices_indices_map(tuple(shape)).items():
            coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
            out[",".join(map(str, coord))] = [[s.start or 0, d if s.stop is None else s.stop]
                                              for s, d in zip(idx, shape)]
        return out

    res = {}
    for name, (shape, axes) in meshes.items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes), axis_types=(AxisType.Auto,) * len(axes))
        for arch in archs:
            mod = get_arch(arch)
            api = mod.api(mod.config(reduced=True))
            structs = jax.eval_shape(api.init, jax.random.PRNGKey(0))
            for over in ("train", "inference"):
                ov = sharding.INFERENCE_OVERRIDES if over == "inference" else None
                shs = jax.tree.leaves(sharding.tree_shardings(structs, mesh, ov))
                for p, leaf, sh in zip(leaf_paths(structs), jax.tree.leaves(structs), shs):
                    res[f"{name}|{arch}|{over}|{p}"] = {
                        "shape": list(leaf.shape), "spec": spec_json(sh.spec),
                        "blocks": blocks(mesh, sh, leaf.shape)}
        for i, (shape_, spec) in enumerate(extra[name]):
            spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
            res[f"{name}|extra|{i}"] = {"blocks": blocks(mesh, NamedSharding(mesh, spec), shape_)}
        for s in cache_shapes:
            for b in (8, 1, 2):
                res[f"{name}|cache|{s}|{b}"] = spec_json(cache_spec(tuple(s), b, mesh))
                res[f"{name}|prefill|{s}|{b}"] = spec_json(
                    cache_spec(tuple(s), b, mesh, prefer_last=True))
                res[f"{name}|batch|{s}|{b}"] = spec_json(_batch_like_spec(tuple(s), b, mesh))
        sharding.set_batch_shard_axes(sharding.batch_axes(mesh),
                                      model_size=dict(mesh.shape)["model"])
        res[f"{name}|divides"] = [sharding.model_divides(n) for n in range(1, 17)]
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def ref():
    arg = json.dumps([MESHES, ARCHS, EXTRA, CACHE_SHAPES])
    r = subprocess.run([sys.executable, "-c", _REFERENCE, arg], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                             JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _mesh(name):
    """The named mesh's dims and sizes, all ``to_placements`` and the rule
    engine read (no process group)."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, mesh=torch.empty(shape), ndim=len(shape))


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _blocks(mesh, spec, shape):
    sizes = tuple(mesh.mesh.shape)
    placements = sharding.to_placements(spec, mesh)
    out = {}
    for flat in range(mesh.mesh.numel()):
        coord = _coords(flat, sizes)
        local, off = _compute_local_shape_and_global_offset(tuple(shape), sizes, coord,
                                                            placements)
        out[",".join(map(str, coord))] = [[o, o + n] for o, n in zip(off, local)]
    return out


def _coords(flat, sizes):
    """The mesh coordinate of rank ``flat`` (row-major, as the mesh lays
    its ranks out)."""
    coord = []
    for s in reversed(sizes):
        flat, c = divmod(flat, s)
        coord.append(c)
    return coord[::-1]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_blocks_equal_reference(ref, mesh_name, arch):
    mesh = _mesh(mesh_name)
    mod = get_arch(arch)
    params = mod.api(mod.config(reduced=True), device="meta").init(
        torch.Generator().manual_seed(0))
    n = 0
    for over in ("train", "inference"):
        ov = sharding.INFERENCE_OVERRIDES if over == "inference" else None
        shs = tree.leaves(sharding.tree_shardings(params, mesh, ov))
        for p, leaf, sh in zip(leaf_paths(params), tree.leaves(params), shs):
            want = ref[f"{mesh_name}|{arch}|{over}|{p}"]
            assert list(leaf.shape) == want["shape"], p
            assert _spec_json(sh.spec) == want["spec"], (over, p)
            assert _blocks(mesh, sh.spec, leaf.shape) == want["blocks"], (over, p)
            n += 1
    assert n == 2 * len([k for k in ref if k.startswith(f"{mesh_name}|{arch}|train|")])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axis_tuples_split_in_the_references_order(ref, mesh_name):
    mesh = _mesh(mesh_name)
    for i, (shape, spec) in enumerate(EXTRA[mesh_name]):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        assert _blocks(mesh, spec, shape) == ref[f"{mesh_name}|extra|{i}"]["blocks"], spec


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_and_batch_specs_equal_reference(ref, mesh_name):
    mesh = _mesh(mesh_name)
    for s in CACHE_SHAPES:
        for b in (8, 1, 2):
            key = f"{s}|{b}".replace("(", "[").replace(")", "]")
            assert _spec_json(cache_spec(s, b, mesh)) == ref[f"{mesh_name}|cache|{key}"]
            assert _spec_json(cache_spec(s, b, mesh, prefer_last=True)) == \
                ref[f"{mesh_name}|prefill|{key}"]
            assert _spec_json(_batch_like_spec(s, b, mesh)) == ref[f"{mesh_name}|batch|{key}"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_model_divides_equals_reference(ref, mesh_name):
    mesh = _mesh(mesh_name)
    kept = (sharding._BATCH_AXES, sharding._MODEL_SIZE)
    try:
        sharding.set_batch_shard_axes(sharding.batch_axes(mesh),
                                      model_size=sharding.axis_sizes(mesh)["model"])
        assert [sharding.model_divides(n) for n in range(1, 17)] == ref[f"{mesh_name}|divides"]
    finally:
        sharding.set_batch_shard_axes(*kept)


def test_constrain_is_the_identity_on_plain_tensors():
    x = torch.randn(8, 4)
    assert sharding.constrain(x, "dp", "model") is x
    assert sharding.constrain_batch(x) is x
    assert sharding.replicate(x) is x
    assert sharding.replicate_dim(x, 0) is x
    assert sharding.kernel_map(lambda a, b: a + b, (x,), whole=(x,)).equal(2 * x)


_FAKE_WORLD = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import fake_mesh
    mesh = fake_mesh((2, 4), ("data", "model"))
    x = DTensor.from_local(torch.randn(8, 12), mesh, (Replicate(), Replicate()))
    out = {}
    def pl(t):
        return [repr(p) for p in t.placements]
    out["dp"] = pl(sharding.constrain(x, "dp", None))
    out["model"] = pl(sharding.constrain(x, None, "model"))
    out["both"] = pl(sharding.constrain(x, "dp", "model"))
    out["tuple"] = pl(sharding.constrain(x, ("data", "model"), None))
    out["missing_axis_is_identity"] = sharding.constrain(x, "pod", None) is x
    out["not_dividing_is_identity"] = sharding.constrain(x, None, ("data", "model")) is x
    y = sharding.constrain(x, "dp", "model")
    out["same_layout_is_identity"] = sharding.constrain(y, "dp", "model") is y
    out["batch"] = pl(sharding.constrain_batch(x))
    out["replicate"] = pl(sharding.replicate(y))
    out["local"] = list(y.to_local().shape)
    print(json.dumps(out))
""")


def test_constrain_redistributes_a_dtensor_in_a_fake_world():
    r = subprocess.run([sys.executable, "-c", _FAKE_WORLD], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["dp"] == ["Shard(dim=0)", "Replicate()"]
    assert out["model"] == ["Replicate()", "Shard(dim=1)"]
    assert out["both"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert out["tuple"] == ["Shard(dim=0)", "Shard(dim=0)"]
    assert out["missing_axis_is_identity"] is True
    assert out["not_dividing_is_identity"] is True
    assert out["same_layout_is_identity"] is True
    assert out["batch"] == ["Shard(dim=0)", "Replicate()"]
    assert out["replicate"] == ["Replicate()", "Replicate()"]
    assert out["local"] == [4, 3]


LM_ARCHS = ("tinyllama-1.1b", "deepseek-v2-236b", "mamba2-370m", "zamba2-1.2b")
LM_TOL = 1e-5


def _rel(got, want):
    return float((got.full_tensor() - want).abs().max() / want.abs().max())


def _lm_world(rank, world_size, shape, archs, out_dir):
    """One rank: each of ``archs``' prefill and decode on DTensors against
    the plain model, and its loss and gradients."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.loop import value_and_grad

    torch.set_num_threads(1)
    mesh = make_local_mesh(*shape)
    sharding.set_batch_shard_axes(("data",), shape[1])

    def laid_out(t, spec_fn):
        return tree.unflatten(t, [sharding.distribute(x, sharding.NamedSharding(
            mesh, spec_fn(tuple(x.shape)))) for x in tree.leaves(t)])

    def params_on(params, overrides):
        shs = tree.leaves(sharding.tree_shardings(params, mesh, overrides))
        return tree.unflatten(params, [sharding.distribute(x, s)
                                       for x, s in zip(tree.leaves(params), shs)])

    b, s, max_len = 4, 8, 16
    res = {}
    for arch in archs:
        mod = get_arch(arch)
        cfg = mod.config(reduced=True)
        cfg = dataclasses.replace(cfg, **{k: "float32" for k in ("param_dtype", "compute_dtype")
                                          if hasattr(cfg, k)})
        api = mod.api(cfg, device="cpu")
        params = api.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, dtype=torch.int32)
        nxt = torch.randint(0, cfg.vocab, (b, 1), generator=gen, dtype=torch.int32)
        batch_spec = lambda shape: _batch_like_spec(shape, b, mesh)  # noqa: E731
        with torch.no_grad():
            pre, cache = api.prefill(params, tokens, api.make_cache(b, max_len))
            dec, _ = api.decode(params, nxt, s, cache)
            with implicit_replication():
                dparams = params_on(params, sharding.INFERENCE_OVERRIDES)
                dcache = laid_out(api.make_cache(b, max_len),
                                  lambda shape: cache_spec(shape, b, mesh, prefer_last=True))
                dpre, dcache = api.prefill(dparams, laid_out(tokens, batch_spec), dcache)
                ddec, _ = api.decode(dparams, laid_out(nxt, batch_spec), s, dcache)
        res[f"{arch}/prefill"], res[f"{arch}/decode"] = _rel(dpre, pre), _rel(ddec, dec)
        if arch != "zamba2-1.2b":
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
                     "mask": torch.ones(b, s)}
            (loss, _), grads = value_and_grad(api.loss_fn)(params, batch)
            with implicit_replication():
                (dloss, _), dgrads = value_and_grad(api.loss_fn)(
                    params_on(params, None), laid_out(batch, batch_spec))
            res[f"{arch}/loss"] = _rel(dloss, loss)
            res[f"{arch}/grads"] = max(_rel(dg, g) for dg, g in zip(tree.leaves(dgrads),
                                                                   tree.leaves(grads)))
    if rank == 0:
        with open(os.path.join(out_dir, "lm.json"), "w") as f:
            json.dump(res, f)


@pytest.mark.parametrize("shape,archs", [((2, 2), LM_ARCHS), ((1, 4), LM_ARCHS[:1])])
def test_dtensor_models_compute_the_plain_functions_in_a_gloo_world(tmp_path, shape, archs):
    from repro_torch.dist import world
    world.spawn(_lm_world, 4, "gloo", shape, archs, str(tmp_path))
    res = json.loads((tmp_path / "lm.json").read_text())
    trained = [a for a in archs if a != "zamba2-1.2b"]
    assert len(res) == 2 * len(archs) + 2 * len(trained)
    for key, rel in res.items():
        assert rel <= LM_TOL, (key, rel)
