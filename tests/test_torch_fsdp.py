"""The port's FSDP planning — the sharding rule engine, ``fsdp_plan``,
``fsdp_step_wire_bytes``, the sharded checkpoint restore and
``host_slice`` — held against the JAX package on the CPU, in one process.
(The step itself, in a gloo world of 8 beside the reference's 8-device
``shard_map``, is ``tests/test_torch_fsdp_world.py``.)

The reference's engine reads a mesh's axis names and sizes only, so it is
handed a stand-in mesh of any sizes (``_Mesh``); the port takes the sizes
themselves.  Full-width numbers are computed from shapes alone (the
port's parameters on the ``meta`` device, the reference's from
``jax.eval_shape``), by both packages, and compared."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import dcn_criteo as jdcn
from repro.configs import dlrm_criteo as jdlrm
from repro.dist import AUTO as JAUTO
from repro.dist import accounting as jacc
from repro.dist import sharding as jsharding
from repro.optim import optimizers as jopt
from repro.train import loop as jloop
from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import dcn_criteo, dlrm_criteo
from repro_torch.data.loader import host_slice
from repro_torch.dist import AUTO, accounting, sharding
from repro_torch.models.dlrm import dlrm_init
from repro_torch.optim import optimizers as topt
from repro_torch.train import loop as tloop

POLICIES = ("none", "bf16", "int8", "auto")
WORLDS = (1, 2, 4, 8)
PATHS = ["embed/table_0", "embed/table_7", "lm_head/w", "layers/moe/wi", "layers/moe/wo",
         "layers/mlp/wi/w", "layers/attn/wq/w", "layers/norm1/g", "tables/3/q",
         "tables/0/table_1", "bottom/1/w", "top/2/b", "frontend_proj/w"]
TEMPLATE_SYMBOLS = [None, "model", "dp", ("pod", "data"), "data", "pod"]


class _Mesh:
    """What the reference's engine reads of a mesh: axis names and sizes."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)
        self.shape = dict(sizes)


def _jpol(name):
    return JAUTO if name == "auto" else name


def _tpol(name):
    return AUTO if name == "auto" else name


def _optimizers():
    """(name, port optimizer, reference optimizer): element-wise, row-wise,
    factored and partitioned state layouts."""
    return [
        ("adagrad", topt.adagrad(1e-2), jopt.adagrad(1e-2)),
        ("rowwise_adagrad", topt.rowwise_adagrad(1e-2), jopt.rowwise_adagrad(1e-2)),
        ("adam", topt.adam(1e-3), jopt.adam(1e-3)),
        ("adafactor", topt.adafactor(), jopt.adafactor()),
        ("partitioned",
         topt.partitioned([(lambda p: "table" in p, topt.rowwise_adagrad(1e-2))],
                          topt.adam(1e-3)),
         jopt.partitioned([(lambda p: "table" in p, jopt.rowwise_adagrad(1e-2))],
                          jopt.adam(1e-3))),
    ]


@functools.lru_cache(maxsize=None)
def _trees(net, reduced=True):
    """The port's parameters on the meta device and the reference's shapes,
    for one config."""
    mod, jmod = {"dlrm": (dlrm_criteo, jdlrm), "dcn": (dcn_criteo, jdcn)}[net]
    cfg, jcfg = mod.config(reduced=reduced), jmod.config(reduced=reduced)
    tparams = mod.api(cfg, device="meta").init(torch.Generator().manual_seed(0))
    jparams = jax.eval_shape(jmod.api(jcfg).init, jax.random.PRNGKey(0))
    return tparams, jparams


# ------------------------------------------------------------ rule engine


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_fit_template_equals_reference(data):
    sizes = {"pod": data.draw(st.integers(1, 4)), "data": data.draw(st.integers(1, 8)),
             "model": data.draw(st.integers(1, 8))}
    shape = tuple(data.draw(st.integers(1, 400)) for _ in range(data.draw(st.integers(0, 4))))
    template = tuple(data.draw(st.sampled_from(TEMPLATE_SYMBOLS))
                     for _ in range(data.draw(st.integers(0, 5))))
    batch = data.draw(st.sampled_from([("data",), ("pod", "data")]))
    got = sharding.fit_template(template, shape, sizes, batch=batch)
    assert got == jsharding.fit_template(template, shape, sizes, batch=batch)
    assert isinstance(got, tuple)


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_spec_for_and_scatter_dims_equal_reference(data):
    axes = data.draw(st.sampled_from([("data",), ("data", "model"), ("pod", "data", "model")]))
    sizes = {a: data.draw(st.integers(1, 8)) for a in axes}
    path = data.draw(st.sampled_from(PATHS))
    shape = tuple(data.draw(st.integers(1, 600)) for _ in range(data.draw(st.integers(0, 3))))
    mesh = _Mesh(sizes)
    for ov in (None, jsharding.INFERENCE_OVERRIDES):
        tov = None if ov is None else sharding.INFERENCE_OVERRIDES
        assert sharding.spec_for(path, shape, sizes, tov) == \
            jsharding.spec_for(path, shape, mesh, ov)
    assert sharding.scatter_dims(path, shape, sizes) == \
        jsharding.scatter_dims(path, shape, mesh)


def test_rule_tables_and_mesh_forms():
    assert sharding.RULES == jsharding.RULES
    assert sharding.INFERENCE_OVERRIDES == jsharding.INFERENCE_OVERRIDES
    assert sharding.batch_axes({"pod": 1, "data": 2, "model": 4}) == ("pod", "data")
    assert sharding.axis_sizes(4) == {"data": 4}
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.axis_sizes(None)
    full = torch.arange(24).reshape(4, 6)
    assert torch.equal(sharding.Shard(1, 2, 3).take(full), full[:, 4:6])
    assert sharding.REPLICATED.take(full) is full
    with pytest.raises(ValueError, match="does not split"):
        sharding.Shard(0, 0, 3).take(full)


# ------------------------------------------------------------ the FSDP plan


@pytest.mark.parametrize("net", ["dlrm", "dcn"])
def test_fsdp_plan_equals_reference(net):
    tparams, jparams = _trees(net)
    for name, topt_, jopt_ in _optimizers():
        for n in WORLDS:
            for pol in POLICIES:
                got = tloop.fsdp_plan(tparams, topt_, n, policy=pol)
                want = jloop.fsdp_plan(jparams, jopt_, _Mesh({"data": n}), policy=pol)
                assert got == [(p, tuple(s), m, d) for p, s, m, d in want], (name, n, pol)
    # the DLRM's tables and dense leaves scatter; row-wise Adagrad's (rows, 1)
    # accumulator admits dim 0 only, Adafactor's factored stats none
    plan = tloop.fsdp_plan(tparams, topt.rowwise_adagrad(1e-2), 8)
    assert all(d in (None, 0) for *_, d in plan)


@pytest.mark.parametrize("net", ["dlrm", "dcn"])
def test_fsdp_step_wire_bytes_equals_reference(net):
    tparams, jparams = _trees(net)
    opt, jopt_ = topt.adagrad(1e-2), jopt.adagrad(1e-2)
    for n in WORLDS:
        for pol in POLICIES:
            for gd in ("float32", "bfloat16"):
                got = accounting.fsdp_step_wire_bytes(tparams, opt, n, _tpol(pol),
                                                      scalar_allreduces=3,
                                                      param_gather_dtype=gd)
                want = jacc.fsdp_step_wire_bytes(jparams, jopt_, _Mesh({"data": n}),
                                                 _jpol(pol), scalar_allreduces=3,
                                                 param_gather_dtype=gd)
                assert got == want, (n, pol, gd)


def test_full_width_closed_forms_equal_reference():
    """DLRM-Criteo at full width over 4 ranks, Adagrad, 3 scalar means: the
    DP and FSDP totals (f32 and bf16 gathers) and the FSDP gradient bytes
    per policy, each equal to the reference's float; 65 of 66 leaves
    scatter (dims 0 and 1), ``top/2/b`` stays on the all-reduce path."""
    tparams, jparams = _trees("dlrm", reduced=False)
    assert sum(p.numel() for p in tree.leaves(tparams)) == 135_528_097
    opt, jopt_, mesh = topt.adagrad(1e-2), jopt.adagrad(1e-2), _Mesh({"data": 4})
    rows = {}
    for pol in POLICIES:
        dp = accounting.dp_step_wire_bytes(tparams, _tpol(pol), 4, scalar_allreduces=3)
        assert dp == jacc.dp_step_wire_bytes(jparams, _jpol(pol), 4, scalar_allreduces=3)
        row = [dp["total_bytes"]]
        for gd in ("float32", "bfloat16"):
            got = accounting.fsdp_step_wire_bytes(tparams, opt, 4, _tpol(pol),
                                                  scalar_allreduces=3, param_gather_dtype=gd)
            assert got == jacc.fsdp_step_wire_bytes(jparams, jopt_, mesh, _jpol(pol),
                                                    scalar_allreduces=3,
                                                    param_gather_dtype=gd)
            assert (got["n_scattered"], got["n_leaves"]) == (65, 66)
            row.append(got["total_bytes"])
        row.append(got["grad_bytes"])
        rows[pol] = row
    plan = tloop.fsdp_plan(tparams, opt, 4, policy="auto")
    assert [p for p, _, _, d in plan if d is None] == ["top/2/b"]
    assert {d for *_, d in plan if d is not None} == {0, 1}
    print("policy: DP total, FSDP total f32 gather, FSDP total bf16 gather, FSDP grad bytes")
    for pol, row in rows.items():
        print(pol, [int(x) if float(x).is_integer() else x for x in row])


def test_fsdp_step_refuses_without_a_group_and_a_bad_gather_dtype():
    params = dlrm_init(dlrm_criteo.config(reduced=True), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tloop.make_fsdp_train_step(lambda p, b: (0.0, {}), topt.adagrad(1e-2), None, params)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tloop.init_fsdp_state(params, topt.adagrad(1e-2))
    with pytest.raises(ValueError, match="param_gather_dtype"):
        tloop._gather_dtype("float16")


# ------------------------------------------------------------ sharded restore


def test_restore_with_shardings_cuts_each_rank_its_block(tmp_path):
    """A state of full leaves restores per rank through ``shardings``: a
    tree of ``Shard`` (or one for every leaf), each leaf cut before it
    moves, the full and replicated leaves untouched; ``restore_latest``
    passes them on."""
    from repro_torch.dist.sharding import REPLICATED, Shard
    rng = np.random.default_rng(0)
    full = {"a": torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)),
            "b": [torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32))],
            "s": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 3, full)
    for n in (1, 2, 4):
        for r in range(n):
            sh = {"a": Shard(0, r, n), "b": [Shard(1, r, n)], "s": REPLICATED}
            got, _ = ckpt.restore(str(tmp_path), 3, full, shardings=sh)
            assert torch.equal(got["a"], full["a"][r * 8 // n:(r + 1) * 8 // n])
            assert torch.equal(got["b"][0], full["b"][0][:, r * 12 // n:(r + 1) * 12 // n])
            assert torch.equal(got["s"], full["s"])
            assert got["a"].untyped_storage().nbytes() == got["a"].numel() * 4
    two = {"a": full["a"], "b": full["b"]}
    ckpt.save(str(tmp_path / "two"), 5, two)
    step, got, _ = ckpt.restore_latest(str(tmp_path / "two"), two, shardings=Shard(0, 1, 2))
    assert step == 5 and torch.equal(got["b"][0], full["b"][0][2:])
    with pytest.raises(ValueError, match="shardings has 2 leaves"):
        ckpt.restore(str(tmp_path), 3, full, shardings=[REPLICATED, REPLICATED])


def test_fsdp_state_shardings_follow_the_plan():
    """The restore layout of an FSDP state: parameters and step whole, each
    optimizer leaf cut on its scatter dim, every residual on its rank dim."""
    params = dlrm_init(dlrm_criteo.config(reduced=True), torch.Generator().manual_seed(0), "cpu")
    opt = topt.adam(1e-3)
    plan = tloop.fsdp_plan(params, opt, 4, policy="auto")
    like = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32),
            "err": tree.tree_map(lambda p: torch.zeros((4,) + tuple(p.shape)), params)}
    sh = tloop.fsdp_state_shardings(like, plan, 2, 4)
    assert len(tree.leaves(sh)) == len(tree.leaves(like))
    assert all(s.count == 1 for s in tree.leaves(sh["params"])) and sh["step"].count == 1
    for entry, (_, _, _, dim) in zip(sh["opt"], plan):
        for s in tree.leaves(entry):        # adam: m and v
            assert (s.count, s.dim, s.index) == ((1, 0, 0) if dim is None else (4, dim, 2))
    assert all((s.dim, s.index, s.count) == (0, 2, 4) for s in tree.leaves(sh["err"]))


def test_host_slice_splits_dim_0_over_the_processes():
    batch = {"x": torch.arange(24).reshape(12, 2), "y": torch.arange(12)}
    assert host_slice(batch) is batch                       # no group: the whole batch
    for pc in (1, 2, 3, 4):
        parts = [host_slice(batch, process_index=i, process_count=pc) for i in range(pc)]
        assert torch.equal(torch.cat([p["x"] for p in parts]), batch["x"])
        assert all(p["y"].shape[0] == 12 // pc for p in parts)
    from repro.data.loader import host_slice as jhost_slice
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for pc in (2, 3):
        for i in range(pc):
            got = host_slice(batch, process_index=i, process_count=pc)
            want = jhost_slice(jb, process_index=i, process_count=pc)
            for k in batch:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
