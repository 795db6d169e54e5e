"""The port's dry run (``launch.dryrun``, ``launch.cost_analysis``,
``benchmarks.roofline`` / ``hillclimb``) held against the JAX package's
lowering and against closed forms.

Both sides run in subprocesses started together: the reference with 8
forced host devices and ``Auto`` mesh axes (jax 0.9's ``Explicit`` default
refuses ``with_sharding_constraint``; ROADMAP §3), the port on fake process
groups (which belong to the whole process).  Reduced tinyllama-1.1b at the
reference test's shapes (``train_4k`` → 8 × 64, ``decode_32k`` → 8 × 64)
on ``(data=2, model=4)`` and ``(pod=2, data=2, model=2)``:

* per-GPU argument bytes equal the reference's
  ``memory_analysis().argument_size_in_bytes`` (decode: less the 4 bytes of
  the int32 position, an argument there and a Python int here);
* decode flops equal the reference's less the products GSPMD computes
  whole on every ``model`` rank: the two output projections (attention's
  ``wo`` and the MLP's ``wo``, whose outputs ``constrain_batch`` pins
  whole) and, where the model axis does not divide the kv heads, ``wk`` and
  ``wv`` — GSPMD gathers their weights and multiplies whole, DTensor
  multiplies its split and gathers the output, so each costs
  ``(1 − 1/m)`` of its flops more in the reference.  Held exactly;
* train flops lie between 0.70 and 1.00 of the reference's: the same
  products, whole in the reference's forward, backward and rematerialised
  forward, are the difference (no closed form: the backward's products
  split differently), and the port never counts more;
* train on a mesh with data > 1 has wire bytes > 0.

And: on a ``(1, 1)`` mesh the per-GPU flops equal ``FlopCounterMode`` over
the same call without DTensor; a split ``mm`` on ``(2, 4)`` counts exactly
``2·(B/2)·K·(N/4)`` (DTensor's sharding propagation on global shapes is
not counted); the ring formulas give ``test_hlo_analyzer_collective_formulas``'
bytes, and an all-reduce through DTensor its formula's; the layer
multiplier equals the unrolled count at depth 10; ``roofline.analyze_cell``
and ``hillclimb`` run on a recorded full-width cell.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch.cost_analysis import wire_bytes

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.common import lowerables, Shape
    import repro.configs.common as common
    from repro.launch.hlo_analysis import analyze_compiled
    common.SHAPES = {"train_4k": Shape("train_4k", 64, 8, "train"),
                     "decode_32k": Shape("decode_32k", 64, 8, "decode")}
    res = {}
    for shape, axes in [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]:
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
        mod = get_arch("tinyllama-1.1b")
        api = mod.api(mod.config(reduced=True))
        for s in ("train_4k", "decode_32k"):
            fn, args = lowerables(api, s, mesh)
            with mesh:
                compiled = jax.jit(fn).lower(*args).compile()
            a = analyze_compiled(compiled, total_devices=mesh.size)
            res[f"{len(shape)}d-{s}"] = {
                "flops": a["flops_per_chip"], "wire": a["collective_wire_bytes_per_chip"],
                "args": a["memory_analysis"]["argument_size_in_bytes"]}
    print(json.dumps(res))
""")

_PORT = textwrap.dedent("""
    import dataclasses, json, os, subprocess, sys, tempfile
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    import repro_torch.configs.common as common
    from repro_torch.configs.common import Shape, lowerables
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import analyze_call
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.train.loop import init_state, make_train_step
    SHAPES = common.SHAPES
    common.SHAPES = {"train_4k": Shape("train_4k", 64, 8, "train"),
                     "decode_32k": Shape("decode_32k", 64, 8, "decode")}
    mod = get_arch("tinyllama-1.1b")
    cfg = mod.config(reduced=True)
    res = {}
    for shape, axes in [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]:
        mesh = fake_mesh(shape, axes)
        for s in ("train_4k", "decode_32k"):
            fn, args = lowerables(mod.api(cfg, device="meta"), s, mesh)
            a = analyze_call(fn, args, mesh)
            res[f"{len(shape)}d-{s}"] = {
                "flops": a["flops_per_chip"], "wire": a["collective_wire_bytes_per_chip"],
                "args": a["memory_analysis"]["argument_size_in_bytes"]}
        if shape == (2, 4):
            x = DTensor.from_local(torch.empty(8, 96, device="meta"), mesh,
                                   (Shard(0), Replicate()), run_check=False)
            w = DTensor.from_local(torch.empty(96, 3, device="meta"), mesh,
                                   (Replicate(), Shard(1)), run_check=False)
            res["mm"] = analyze_call(lambda a, b: a @ b, (x, w), mesh)["flops_per_chip"]
            deep = dataclasses.replace(cfg, n_layers=10)     # traced at depths 2 and 6
            for s in ("train_4k", "decode_32k"):
                full = dryrun.analyze(mod, deep, s, mesh, unroll=True)
                mult = dryrun.analyze(mod, deep, s, mesh)
                keys = ("flops_per_chip", "hbm_bytes_per_chip", "collective_wire_bytes_per_chip",
                        "local_ops")
                res[f"multiplier-{s}"] = {k: [full[k], mult[k]] for k in keys}
                res[f"multiplier-{s}"]["args"] = [
                    full["memory_analysis"]["argument_size_in_bytes"],
                    mult["memory_analysis"]["argument_size_in_bytes"]]
        if shape == (2, 2, 2):
            y = DTensor.from_local(torch.empty(64, device="meta"), mesh,
                                   (Replicate(), Replicate(), Partial()), run_check=False)
            res["all_reduce"] = analyze_call(
                lambda t: t.redistribute(mesh, (Replicate(),) * 3), (y,), mesh)
    mesh = fake_mesh((1, 1), ("data", "model"))
    for s in ("train_4k", "decode_32k"):
        api = mod.api(cfg, device="meta")
        fn, args = lowerables(api, s, mesh)
        counted = analyze_call(fn, args, mesh)["flops_per_chip"]
        params = api.init(torch.Generator().manual_seed(0))
        shape_ = common.SHAPES[s]
        if s == "train_4k":
            plain_fn = make_train_step(api.loss_fn, api.optimizer, accum=api.accum)
            plain_args = (init_state(params, api.optimizer), api.train_batch(shape_))
        else:
            plain_fn = api.decode
            plain_args = (params, torch.empty(8, 1, dtype=torch.int32, device="meta"), 0,
                          api.make_cache(8, 64))
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            plain_fn(*plain_args)
        res[f"one-{s}"] = [counted, fc.get_total_flops()]
    common.SHAPES = SHAPES
    with tempfile.TemporaryDirectory() as d:
        rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", False, d, force=True)
        from repro_torch.benchmarks import roofline
        res["cell"] = roofline.analyze_cell(rec)
        hc = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.hillclimb",
                             "tinyllama-1.1b", "decode_32k", "t"], capture_output=True,
                            text=True, cwd=d)
        res["hillclimb"] = [hc.returncode, hc.stdout]
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=env)
             for name, code in (("ref", _REFERENCE), ("port", _PORT))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, (name, stderr[-3000:])
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _excess(b_local, m, kv_split, d=64, d_ff=128, d_kv=32, layers=2):
    """Flops the reference spends at decode on products GSPMD computes whole
    on every model rank: ``(1 − 1/m)`` of attention's ``wo`` (d × d), the
    MLP's ``wo`` (d_ff × d) and, unless the kv heads split, ``wk`` and
    ``wv`` (d × d_kv), per layer, for one token per row."""
    per = 2 * b_local * (d * d + d_ff * d + (0 if kv_split else 2 * d * d_kv))
    return layers * per * (1 - 1 / m)


@pytest.mark.parametrize("mesh,b_local,m,kv_split", [("2d", 4, 4, False), ("3d", 2, 2, True)])
def test_decode_flops_and_arguments_equal_reference(runs, mesh, b_local, m, kv_split):
    ref, port = runs["ref"][f"{mesh}-decode_32k"], runs["port"][f"{mesh}-decode_32k"]
    assert port["args"] + 4 == ref["args"]
    assert port["flops"] == ref["flops"] - _excess(b_local, m, kv_split)


@pytest.mark.parametrize("mesh", ["2d", "3d"])
def test_train_flops_and_arguments_agree_with_reference(runs, mesh):
    ref, port = runs["ref"][f"{mesh}-train_4k"], runs["port"][f"{mesh}-train_4k"]
    assert port["args"] == ref["args"]
    assert 0.70 * ref["flops"] <= port["flops"] <= ref["flops"]
    assert port["wire"] > 0 and ref["wire"] > 0


def test_one_device_mesh_counts_what_flop_counter_counts(runs):
    for s in ("train_4k", "decode_32k"):
        counted, plain = runs["port"][f"one-{s}"]
        assert counted == plain > 0, s


def test_split_mm_counts_the_local_product(runs):
    # (16, 96) split over data = 2 by (96, 12) split over model = 4
    assert runs["port"]["mm"] == 2 * (16 // 2) * 96 * (12 // 4)


def test_ring_formulas():
    # test_hlo_analyzer_collective_formulas' cases: f32[64] all-reduce and the
    # f32[256] all-gather over 4, a 256-byte permute
    assert wire_bytes("all-reduce", 256, 4) == 384
    assert wire_bytes("all-gather", 1024, 4) == 768
    assert wire_bytes("collective-permute", 256, 4) == 256
    assert wire_bytes("reduce-scatter", 64, 4) == 192
    assert wire_bytes("all-to-all", 1024, 4) == 768
    assert wire_bytes("all-reduce", 256, 1) == 0


def test_dtensor_all_reduce_counts_its_ring_bytes(runs):
    a = runs["port"]["all_reduce"]
    # f32[64] Partial over model = 2: 2·(1/2)·256 B on the model axis
    assert a["collective_wire_bytes_per_chip"] == 256
    assert a["collective_wire_bytes_by_axis"] == {"model": 256}
    assert a["collectives"]["all-reduce"]["count"] == 1


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_layer_multiplier_equals_unrolled_count(runs, shape):
    for key, (full, mult) in runs["port"][f"multiplier-{shape}"].items():
        assert full == mult, key


def test_roofline_and_hillclimb_on_a_recorded_cell(runs):
    c = runs["port"]["cell"]
    assert c["arch"] == "tinyllama-1.1b" and c["mesh"] == "pod_32x8"
    assert c["dominant"] in ("compute", "memory", "collective")
    assert 0 < c["model_over_counted_flops"] <= 1.0
    assert c["memory_t_s"] > 0 and c["compute_t_s"] > 0 and 0 < c["roofline_frac"] <= 1.0
    rc, out = runs["port"]["hillclimb"]
    assert rc == 0 and "dominant=" in out and "MODEL/counted=" in out
