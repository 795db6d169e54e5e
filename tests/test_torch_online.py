"""The port's online re-planning (``online/``), its drift stream and its TSV
reader, held against the JAX package.

* The detector gives the reference's decision sequence on the same
  telemetry windows (hysteresis, cooldown, abstention, ``rebase``).
* Migration on parameters drawn by JAX and carried across equals JAX's
  migrated arrays within 1e-5 (f32: the old rows' gathers are exact, the
  width changes multiply in another order; numpy's pseudo-inverse on both
  sides); same-spec migration is a bitwise copy, fold-head ids are exact,
  int8 sources dequantize, and the optimizer moments' carried/reset
  decisions and arrays equal the reference's.
* ``drifted_batch_at`` is the port's ``batch_at`` bit for bit while the
  drift is inactive; when active its id transform equals the reference's
  expression on the same uniforms.
* The controller, fed the same request stream as the reference's (numpy,
  drawn once), fires in the same windows and swaps to a plan equal to the
  reference's field for field; the swapped engine equals a fresh one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partitions as jparts
from repro.core.factory import EmbeddingSpec as JSpec
from repro.core.factory import make_embedding as jmake
from repro.data import criteo as jcriteo
from repro.models.dlrm import DLRMConfig as JCfg
from repro.models.dlrm import dlrm_init as jax_dlrm_init
from repro.obs import Obs as JObs
from repro.online import ReplanController as JController
from repro.online import migrate as jmig
from repro.online.drift import DriftDetector as JDetector
from repro.online.drift import DriftThresholds as JThresholds
from repro.optim import optimizers as jopt
from repro.plan.freq import FeatureStats as JStats
from repro.plan.planner import build_plan as jbuild_plan
from repro.plan.planner import full_table_bytes
from repro.serve import cache as jcache
from repro.serve.quantize import quantize_params as jquant
from repro.serve.recsys import RecsysEngine as JaxEngine
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import partitions as tparts
from repro_torch.core.factory import EmbeddingSpec as TSpec
from repro_torch.core.factory import make_embedding as tmake
from repro_torch.data import criteo as tcriteo
from repro_torch.models.dlrm import DLRMConfig as TCfg
from repro_torch.obs import Obs
from repro_torch.online import ReplanController, migrate
from repro_torch.online.drift import DriftDetector, DriftThresholds
from repro_torch.optim import optimizers as topt
from repro_torch.plan import MemoryPlan, plan_differences
from repro_torch.plan.freq import FeatureStats
from repro_torch.serve.cache import DeviceHotRowCache
from repro_torch.serve.recsys import RecsysEngine

SIZES = (60, 40, 500)
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small tensors: test files run
    side by side in worker processes, and idle spinning threads of several
    of them at once slow every process on the host."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _np(x):
    return np.asarray(x.detach().cpu().float() if torch.is_tensor(x) else x, np.float32)


def _tp(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def _stats_of(ids, size, cls):
    uq, ct = np.unique(np.asarray(ids, np.int64), return_counts=True)
    return cls(size=size, ids=uq, probs=(ct / ct.sum()).astype(np.float64))


def _cfgs(jplan, emb_dim=8, **kw):
    base = dict(name="dlrm-criteo", table_sizes=SIZES, emb_dim=emb_dim, bottom_mlp=(8, 8),
                top_mlp=(8,), dense_dim=4)
    tplan = MemoryPlan.from_json(jplan.to_json())
    return JCfg(embedding=jplan, **base), TCfg(embedding=tplan, **base, **kw)


def _decision(d):
    """A ``DriftDecision``'s fields (the two packages' classes never compare
    equal as objects)."""
    return dataclasses.astuple(d)


def _assert_trees_close(got, want, tol=F32_TOL):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w.astype(np.float32), rtol=0,
                                   atol=tol * max(1.0, float(np.abs(w).max(initial=0.0))))


# --------------------------------------------------------- drift detector


class _Telemetry:
    """Duck-typed telemetry: one window's lookups + measured masses."""

    def __init__(self, lookups, measured):
        self._lookups, self._measured = lookups, measured

    def observed_lookups(self, i):
        return self._lookups[i]

    def measured_collision_mass(self, module, i):
        return self._measured[i]


@pytest.mark.parametrize("knobs", [
    dict(rel_gap=0.5, abs_gap=0.0, min_lookups=10, hysteresis=2, cooldown=2),
    dict(rel_gap=0.2, abs_gap=1e-3, min_lookups=60, hysteresis=1, cooldown=3),
    dict(rel_gap=0.6, abs_gap=1e-4, min_lookups=30, hysteresis=3, cooldown=0,
         collision_scale=1.7),
])
def test_detector_decisions_equal_reference(knobs):
    rng = np.random.default_rng(0)
    predicted = list(rng.random(4) * 0.1)
    tdet = DriftDetector([None] * 4, predicted, DriftThresholds(**knobs))
    jdet = JDetector([None] * 4, predicted, JThresholds(**knobs))
    for k in range(40):
        window = _Telemetry(list(rng.integers(0, 100, 4)),
                            list(np.asarray(predicted) * rng.random(4) * 3.0))
        if k == 20:                          # a rebase mid-stream: full cooldown
            rebased = list(rng.random(4) * 0.2)
            tdet.rebase([None] * 4, rebased)
            jdet.rebase([None] * 4, rebased)
        assert _decision(tdet.check(window)) == _decision(jdet.check(window))
    assert (tdet.fires, tdet.checks) == (jdet.fires, jdet.checks)
    assert tdet.fires > 0


def test_detector_from_stats_on_telemetry_equals_reference():
    from repro.obs import CollisionTelemetry as JTelemetry
    from repro_torch.obs import CollisionTelemetry

    spec = JSpec(kind="hash", num_collisions=4)
    jmods = [jmake(s, 8, spec) for s in SIZES]
    tmods = [tmake(s, 8, TSpec(kind="hash", num_collisions=4)) for s in SIZES]
    rng = np.random.default_rng(1)
    base = [rng.integers(0, s, 300) for s in SIZES]
    th = dict(rel_gap=0.3, abs_gap=1e-4, min_lookups=20, hysteresis=2, cooldown=1)
    tdet = DriftDetector.from_stats(tmods, [_stats_of(b, s, FeatureStats)
                                            for b, s in zip(base, SIZES)], DriftThresholds(**th))
    jdet = JDetector.from_stats(jmods, [_stats_of(b, s, JStats) for b, s in zip(base, SIZES)],
                                JThresholds(**th))
    assert tdet.predicted == jdet.predicted
    for w in range(6):
        tt, jt = CollisionTelemetry(SIZES), JTelemetry(SIZES)
        spread = 0.5 + w * 0.5
        idx = np.stack([np.floor(rng.random((16, 3)) ** spread * s).astype(np.int64)
                        for s in SIZES], axis=1)
        mask = np.ones(idx.shape, np.float32)
        tt.record(idx, mask)
        jt.record(idx, mask)
        assert _decision(tdet.check(tt)) == _decision(jdet.check(jt))


# ------------------------------------------------------------- index maps


@pytest.mark.parametrize("make", [
    lambda p: p.RemainderPartition(size=50, num_buckets=7, m=7),
    lambda p: p.QuotientPartition(size=50, num_buckets=8, m=7),
    lambda p: p.qr_partitions(500, 16)[0],
    lambda p: p.qr_partitions(500, 16)[1],
    lambda p: p.generalized_qr_partitions(1000, (10, 10, 10))[2],
    lambda p: p.crt_partitions(300, (7, 11, 13))[1],
    lambda p: p.ExplicitPartition(size=12, num_buckets=4,
                                  table=np.array([3, 1, 1, 0, 3, 2, 2, 0, 1, 3, 0, 2])),
])
def test_representative_ids_equal_reference(make):
    got = migrate.representative_ids(make(tparts))
    want = jmig.representative_ids(make(jparts))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


# ------------------------------------------------------------- migration

SPECS = {
    "full": dict(kind="full"),
    "hash4": dict(kind="hash", num_collisions=4),
    "qr2": dict(kind="qr", num_collisions=2, threshold=1),
    "qr8": dict(kind="qr", num_collisions=8, threshold=1),
    "qr4add": dict(kind="qr", num_collisions=4, threshold=1, op="add"),
    "qr4concat": dict(kind="qr", num_collisions=4, threshold=1, op="concat"),
    "mixed_radix": dict(kind="mixed_radix", threshold=1),
}
PAIRS = [("full", "hash4"), ("full", "qr2"), ("qr8", "full"), ("qr2", "qr8"),
         ("hash4", "qr4add"), ("qr2", "qr4concat"), ("full", "mixed_radix"),
         ("qr8", "qr8"), ("hash4", "hash4")]


def _feature(old, new, size=120, dims=(8, 8), quant=False):
    jo, jn = jmake(size, dims[0], JSpec(**SPECS[old])), jmake(size, dims[1], JSpec(**SPECS[new]))
    to, tn = tmake(size, dims[0], TSpec(**SPECS[old])), tmake(size, dims[1], TSpec(**SPECS[new]))
    jold, jfresh = jo.init(jax.random.PRNGKey(0)), jn.init(jax.random.PRNGKey(1))
    if quant:
        jold = jquant({"tables": [jold]}, mode="int8")["tables"][0]
    return (jo, jold, jn, jfresh), (to, _tp(jold), tn, _tp(jfresh))


@pytest.mark.parametrize("old,new", PAIRS)
def test_migrate_feature_equals_reference(old, new):
    (jo, jold, jn, jfresh), (to, told, tn, tfresh) = _feature(old, new)
    jout, jpe, jdec = jmig.migrate_feature(jo, jold, jn, jfresh)
    tout, tpe, tdec = migrate.migrate_feature(to, told, tn, tfresh)
    assert tdec == jdec and tpe is None and jpe is None
    assert set(tout) == set(jout)
    for k in jout:
        assert tout[k].dtype == tfresh[k].dtype and tout[k].shape == tfresh[k].shape
        np.testing.assert_allclose(_np(tout[k]), np.asarray(jout[k]), rtol=0, atol=F32_TOL)
    if old == new:                        # same spec: a bitwise copy
        assert tdec["decision"] == "copied"
        for k in told:
            assert torch.equal(tout[k], told[k])


@pytest.mark.parametrize("new", ["hash4", "qr2", "qr8"])
def test_folded_head_ids_are_exact(new):
    _, (to, told, tn, tfresh) = _feature("full", new, size=200)
    out, _, dec = migrate.migrate_feature(to, told, tn, tfresh)
    assert dec["decision"] == "folded"
    from repro_torch.plan.quality import module_partitions
    head = min(p.num_buckets for p in module_partitions(tn))
    xs = torch.arange(min(head, 32))
    torch.testing.assert_close(tn.apply(out, xs), to.apply(told, xs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("old,new", [("qr2", "qr2"), ("qr2", "full"), ("hash4", "qr8")])
def test_int8_sources_dequantize_as_the_reference(old, new):
    (jo, jold, jn, jfresh), (to, told, tn, tfresh) = _feature(old, new, quant=True)
    jout, _, jdec = jmig.migrate_feature(jo, jold, jn, jfresh)
    tout, _, tdec = migrate.migrate_feature(to, told, tn, tfresh)
    assert tdec == jdec
    for k in jout:
        np.testing.assert_allclose(_np(tout[k]), np.asarray(jout[k]), rtol=0, atol=F32_TOL)
    xs = torch.arange(32)
    if old == new:
        torch.testing.assert_close(tn.apply(tout, xs), to.apply(told, xs), rtol=0, atol=1e-6)


def _plan(seed, frac, dims=None):
    rng = np.random.default_rng(seed)
    stats = [_stats_of(np.floor(rng.random(400) ** 1.5 * s), s, JStats) for s in SIZES]
    return jbuild_plan(stats, 8, full_table_bytes(SIZES, 8) // frac, arch="t", dims=dims)


def _plans(seed, dims=None, frac=6):
    return _plan(seed, 1), _plan(seed, frac, dims)


# (old budget fraction, old widths, new fraction, new widths, int8 source):
# kinds change at one width; 8 -> 4 through the new projection's
# pseudo-inverse; 4 -> 8 through the old projection; 4 -> 4 with kinds
# changing and the projection carried
MIGRATIONS = [(1, None, 6, None, False), (1, None, 20, (2, 4, 8), False),
              (20, (4, 8), 3, None, True), (6, (4, 8), 20, (2, 4, 8), False),
              (1, None, 20, (2, 4, 8), True)]


@pytest.mark.parametrize("old_frac,old_dims,new_frac,new_dims,quant", MIGRATIONS)
def test_migrate_params_equals_reference(old_frac, old_dims, new_frac, new_dims, quant):
    plan_old, plan_new = _plan(3, old_frac, old_dims), _plan(3, new_frac, new_dims)
    (jold_cfg, told_cfg), (jnew_cfg, tnew_cfg) = _cfgs(plan_old), _cfgs(plan_new)
    jold = jax_dlrm_init(jax.random.PRNGKey(0), jold_cfg)
    if quant:
        jold = jquant(jold, mode="int8")
    jfresh = jax_dlrm_init(jax.random.PRNGKey(1), jnew_cfg)
    jmig_p, jrep = jmig.migrate_params(jold_cfg, jold, jnew_cfg, jfresh)
    tmig_p, trep = migrate.migrate_params(told_cfg, _tp(jold), tnew_cfg, _tp(jfresh))
    assert trep == jrep
    _assert_trees_close(tmig_p, jmig_p)
    assert trep["counts"].get("folded")
    assert ("proj" in tmig_p) == any(d != 8 for d in plan_new.table_dims)


def test_same_plan_migration_is_a_bitwise_noop():
    plan, _ = _plans(4)
    jcfg, tcfg = _cfgs(plan)
    jold = jax_dlrm_init(jax.random.PRNGKey(0), jcfg)
    told = _tp(jold)
    out, rep = migrate.migrate_params(tcfg, told, tcfg, _tp(jax_dlrm_init(jax.random.PRNGKey(1),
                                                                          jcfg)))
    assert rep["counts"] == {"copied": len(SIZES)}
    for a, b in zip(tree.leaves(out), tree.leaves(told)):
        assert torch.equal(a, b)


def test_migrate_params_rejects_changed_feature_set():
    plan, _ = _plans(5)
    jcfg, tcfg = _cfgs(plan)
    params = _tp(jax_dlrm_init(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="feature set"):
        migrate.migrate_params(tcfg, params, dataclasses.replace(tcfg, table_sizes=(60, 40, 400)),
                               params)


def test_migrate_opt_state_equals_reference():
    plan_old, plan_new = _plans(6)
    (jold_cfg, told_cfg), (jnew_cfg, tnew_cfg) = _cfgs(plan_old), _cfgs(plan_new)
    jold = jax_dlrm_init(jax.random.PRNGKey(0), jold_cfg)
    jmigp, _ = jmig.migrate_params(jold_cfg, jold, jnew_cfg,
                                   jax_dlrm_init(jax.random.PRNGKey(1), jnew_cfg))
    jo = jopt.adagrad(1e-2)
    jstate = [jax.tree.map(lambda x: x + 7.0, s) for s in jo.init(jold)]
    jnew, jdec = jmig.migrate_opt_state(jold, jstate, jmigp, jo)
    tnew, tdec = migrate.migrate_opt_state(_tp(jold), _tp(jstate), _tp(jmigp), topt.adagrad(1e-2))
    assert tdec == jdec
    assert set(tdec.values()) == {"carried", "reset"}
    _assert_trees_close(tnew, jnew, tol=0.0)


# ------------------------------------------------------- drift generator

SPEC_KW = dict(table_sizes=(100, 5000, 10131227), dense_dim=4, zipf=1.5, noise=0.5)


@pytest.mark.parametrize("step", [0, 5, 9, 30])
def test_inactive_drift_is_batch_at_bit_for_bit(step):
    spec = tcriteo.CriteoSpec(**SPEC_KW)
    drift = tcriteo.DriftSpec(shift_step=10, zipf_after=0.7, rotate_frac=0.5,
                              crowd_step=20, crowd_len=5, crowd_frac=0.4)
    b = tcriteo.drifted_batch_at(3, step, 64, spec, None if step == 30 else drift, "cpu")
    a = tcriteo.batch_at(3, step, 64, spec, "cpu")
    if step in (0, 5, 9, 30):
        for k in a:
            assert torch.equal(a[k], b[k])


def _reference_ids(u, sizes, zipf, rotate_frac, crowd_u, crowd_frac):
    """The reference's id expression (``data/criteo.py:115-127``) in jnp."""
    sizes = jnp.asarray(sizes)
    sparse = jnp.floor((jnp.asarray(u) ** zipf) * sizes).astype(jnp.int32)
    sparse = jnp.minimum(sparse, sizes - 1)
    if rotate_frac:
        off = jnp.floor(sizes * rotate_frac).astype(jnp.int32)
        sparse = (sparse + off[None, :]) % sizes
    if crowd_u is not None:
        pick = jnp.asarray(crowd_u) < crowd_frac
        sparse = jnp.where(pick, ((2 * sizes) // 3).astype(jnp.int32)[None, :], sparse)
    return np.asarray(sparse)


def _port_ids(u, sizes, zipf, rotate, cu, crowd):
    return tcriteo.drifted_ids(torch.from_numpy(u), torch.tensor(sizes, dtype=torch.float32),
                               zipf, rotate, None if cu is None else torch.from_numpy(cu),
                               crowd or 0.0).numpy()


@pytest.mark.parametrize("zipf,rotate,crowd", [(0.7, 0.5, None), (3.0, 0.25, 0.3),
                                               (1.5, 0.0, 0.6), (0.7, 0.5, 0.2)])
def test_drifted_id_transform_equals_reference_expression(zipf, rotate, crowd):
    """Exact on the same powered uniforms; with the power inside, the ids
    differ only where torch's and XLA's f32 ``u ** zipf`` do (by one ulp),
    and there by at most one id."""
    rng = np.random.default_rng(7)
    sizes = SPEC_KW["table_sizes"]
    u = rng.random((4096, len(sizes))).astype(np.float32)
    cu = None if crowd is None else rng.random(u.shape).astype(np.float32)
    powered = (torch.from_numpy(u) ** zipf).numpy()
    np.testing.assert_array_equal(_port_ids(powered, sizes, 1.0, rotate, cu, crowd),
                                  _reference_ids(powered, sizes, 1.0, rotate, cu, crowd))
    got, want = _port_ids(u, sizes, zipf, rotate, cu, crowd), \
        _reference_ids(u, sizes, zipf, rotate, cu, crowd)
    same_power = powered == np.asarray(jnp.asarray(u) ** zipf)
    np.testing.assert_array_equal(got[same_power], want[same_power])
    diff = np.abs(got.astype(np.int64) - want)
    sizes_b = np.broadcast_to(np.asarray(sizes), got.shape)
    assert ((diff <= 1) | (diff == sizes_b - 1)).all()      # one id, modulo the rotation


def test_active_drift_uses_the_steps_own_draws():
    spec = tcriteo.CriteoSpec(**SPEC_KW)
    drift = tcriteo.DriftSpec(shift_step=10, zipf_after=0.7, rotate_frac=0.5,
                              crowd_step=20, crowd_len=5, crowd_frac=0.4)
    for step in (12, 22):
        got = tcriteo.drifted_batch_at(3, step, 64, spec, drift, "cpu")
        again = tcriteo.drifted_batch_at(3, step, 64, spec, drift, "cpu")
        plain = tcriteo.batch_at(3, step, 64, spec, "cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)
        assert torch.equal(got["dense"], plain["dense"])     # the same generator's draws
        assert not torch.equal(got["sparse"], plain["sparse"])
        dense, u, noise = tcriteo._draws(3, step, 64, spec, "cpu")
        cu = None
        if drift.crowded(step):
            gen = torch.Generator().manual_seed(tcriteo._step_seed(3, step, "crowd"))
            cu = torch.rand(u.shape, generator=gen)
        powered = (u ** 0.7).numpy()
        want = _reference_ids(powered, spec.table_sizes, 1.0, 0.5,
                              None if cu is None else cu.numpy(), 0.4)
        np.testing.assert_array_equal(got["sparse"].numpy(), want)
        relabelled = tcriteo._labelled(3, dense, got["sparse"], noise, spec, "cpu")
        assert torch.equal(relabelled["label"], got["label"])


def test_flash_crowd_concentrates_traffic():
    spec = tcriteo.CriteoSpec(table_sizes=(1000,), dense_dim=4, zipf=1.5, noise=0.5)
    drift = tcriteo.DriftSpec(crowd_step=0, crowd_len=100, crowd_frac=0.6)
    batch = tcriteo.drifted_batch_at(0, 5, 512, spec, drift, "cpu")
    ids, counts = np.unique(batch["sparse"].numpy(), return_counts=True)
    assert ids[counts.argmax()] == 666 and counts.max() / counts.sum() > 0.5
    after = tcriteo.drifted_batch_at(0, 200, 512, spec, drift, "cpu")
    assert torch.equal(after["sparse"], tcriteo.batch_at(0, 200, 512, spec, "cpu")["sparse"])


# -------------------------------------------------------------- TSV reader

TSV = "\n".join([
    "1\t3\t\t7\t0\t12\t-1\t5\t2\t9\t1\t0\t4\t8\t" + "\t".join(
        ["68fd1e64", "", "a9b5c8d1", "ffffffff"] + ["%08x" % (k * 2654435761 % 2 ** 32)
                                                   for k in range(22)]),
    "0\t\t1\t\t2\t\t3\t\t4\t\t5\t\t6\t\t" + "\t".join(["%x" % k for k in range(26)]),
    "\t5\t5\t5\t5\t5\t5\t5\t5\t5\t5\t5\t5\t5\t" + "\t".join([""] * 26),
    "1\t0\t0\t0\t0\t0\t0\t0\t0\t0\t0\t0\t0\t0\t" + "\t".join(["deadbeef"] * 26),
    "0\t1\t2\t3\t4\t5\t6\t7\t8\t9\t10\t11\t12\t13\t" + "\t".join(["1"] * 26),
]) + "\n"


@pytest.mark.parametrize("hash_to_size", [True, False])
def test_read_tsv_equals_reference(tmp_path, hash_to_size):
    path = tmp_path / "day.tsv"
    path.write_text(TSV)
    sizes = tcriteo.KAGGLE_TABLE_SIZES if hash_to_size else tuple([2 ** 31 - 1] * 26)
    got = list(tcriteo.read_tsv(str(path), tcriteo.CriteoSpec(table_sizes=sizes), 2,
                                hash_to_size=hash_to_size, device="cpu"))
    want = list(jcriteo.read_tsv(str(path), jcriteo.CriteoSpec(table_sizes=sizes), 2,
                                 hash_to_size=hash_to_size))
    assert len(got) == len(want) == 2               # the last partial batch dropped
    for g, w in zip(got, want):
        for k in w:
            assert g[k].dtype == {"dense": torch.float32, "sparse": torch.int32,
                                  "label": torch.float32}[k]
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# ------------------------------------------------------------ the closed loop


def _concentrated_stats(rng, cls):
    """Feature 2's plan-time traffic is near-point-mass, so the solver
    starves its table (the reference test's configuration)."""
    out = []
    for i, s in enumerate(SIZES):
        ids = np.floor(rng.random(4000) ** 1.5 * s).astype(np.int64)
        if i == 2:
            ids[rng.random(4000) < 0.95] = 0
        out.append(_stats_of(ids, s, cls))
    return out


def _requests(rng, n, spread=False):
    """The reference test's request generator."""
    reqs = []
    for _ in range(n):
        bags = []
        for i, s in enumerate(SIZES):
            if spread and i == 2:
                ids = (np.floor(rng.random(3) ** 0.7 * s).astype(int) + s // 2) % s
            else:
                ids = np.floor(rng.random(3) ** 1.5 * s).astype(int)
                if i == 2:
                    ids[rng.random(3) < 0.95] = 0
            bags.append(list(ids))
        reqs.append((rng.normal(size=4), bags))
    return reqs


def _serve(eng, reqs):
    uids = [eng.submit(d, b) for d, b in reqs]
    done = eng.run_until_drained()
    return np.array([done[u].score for u in uids], np.float64)


def test_controller_fires_in_the_reference_windows_and_swaps_to_its_plan():
    rng = np.random.default_rng(2)
    jstats = _concentrated_stats(rng, JStats)
    tstats = [FeatureStats(size=s.size, ids=s.ids, probs=s.probs) for s in jstats]
    budget = full_table_bytes(SIZES, 8) // 6
    jcfg, tcfg = _cfgs(jbuild_plan(jstats, 8, budget, arch="t"), use_kernel=True)
    jp = jquant(jax_dlrm_init(jax.random.PRNGKey(0), jcfg), mode="int8")
    jeng = JaxEngine(jcfg, jp, max_batch=4, cache=jcache.DeviceHotRowCache(capacity_rows=128),
                     batching="waves", obs=JObs(collisions=True))
    teng = RecsysEngine(tcfg, _tp(jp), max_batch=4, batching="waves", device="cpu",
                        cache=DeviceHotRowCache(capacity_rows=128, device="cpu"),
                        obs=Obs(collisions=True))
    th = dict(min_lookups=16, hysteresis=2, cooldown=1, rel_gap=1.0)
    jctrl = JController(jeng, budget_bytes=budget, thresholds=JThresholds(**th),
                        quantize="int8", plan_stats=jstats)
    tctrl = ReplanController(teng, budget_bytes=budget, thresholds=DriftThresholds(**th),
                             quantize="int8", plan_stats=tstats)
    windows = [_requests(rng, 12) for _ in range(3)] + \
        [_requests(rng, 12, spread=True) for _ in range(6)]
    fired = []
    for reqs in windows:
        np.testing.assert_allclose(_serve(teng, reqs), _serve(jeng, reqs), rtol=0, atol=1e-4)
        jd, td = jctrl.check(), tctrl.check()
        assert _decision(td)[:2] + _decision(td)[3:] == _decision(jd)[:2] + _decision(jd)[3:]
        assert td.gaps.keys() == jd.gaps.keys()
        for k in jd.gaps:
            np.testing.assert_allclose(td.gaps[k], jd.gaps[k], rtol=1e-12)
        fired.append(td.fired)
    assert not any(fired[:3]) and sum(fired) == len(tctrl.replans) == len(jctrl.replans) >= 1
    for trep, jrep in zip(tctrl.replans, jctrl.replans):
        assert trep["plan"] == jrep["plan"] and trep["migration"] == jrep["migration"]
        assert trep["plan"]["total_bytes"] <= trep["plan"]["budget_bytes"]
        assert trep["trigger"]["over"] == jrep["trigger"]["over"]
    # the installed plans are equal field for field, migration notes included
    assert plan_differences(teng.cfg.embedding,
                            MemoryPlan.from_json(jeng.cfg.embedding.to_json())) == []
    assert tctrl.detector.predicted == pytest.approx(jctrl.detector.predicted, rel=1e-12)
    # the swapped engine serves as a fresh engine on the same migrated params
    reqs = _requests(rng, 16, spread=True)
    fresh = RecsysEngine(teng.cfg, teng.params, max_batch=4, batching="waves", device="cpu")
    np.testing.assert_array_equal(_serve(teng, reqs), _serve(fresh, reqs))


def test_controller_requires_collision_telemetry():
    jplan, _ = _plans(8)
    _, tcfg = _cfgs(jplan)
    eng = RecsysEngine(tcfg, _tp(jax_dlrm_init(jax.random.PRNGKey(0), _cfgs(jplan)[0])),
                       max_batch=4, device="cpu", obs=Obs())
    with pytest.raises(ValueError, match="collision"):
        ReplanController(eng, budget_bytes=1 << 20)


def test_controller_bootstraps_on_the_first_window_without_plan_stats():
    rng = np.random.default_rng(4)
    jstats = _concentrated_stats(rng, JStats)
    budget = full_table_bytes(SIZES, 8) // 6
    _, tcfg = _cfgs(jbuild_plan(jstats, 8, budget, arch="t"))
    from repro_torch.models.dlrm import dlrm_init
    eng = RecsysEngine(tcfg, dlrm_init(tcfg, torch.Generator().manual_seed(0), "cpu"),
                       max_batch=4, device="cpu", obs=Obs(collisions=True))
    ctrl = ReplanController(eng, budget_bytes=budget)
    assert ctrl.check() is None and ctrl.checks == 0      # nothing served yet
    _serve(eng, _requests(rng, 8))
    assert ctrl.check() is None and ctrl.detector is not None and ctrl.checks == 1
    _serve(eng, _requests(rng, 8))
    assert ctrl.check() is not None
    forced = ctrl.replan()
    assert forced["trigger"] is None and forced["plan"]["total_bytes"] <= budget
    assert np.isfinite(_serve(eng, _requests(rng, 4))).all()


# ------------------------------------------------------- launcher and bench


def test_launcher_obs_and_replan_flags(tmp_path, monkeypatch, capsys):
    import json

    from repro_torch.launch import serve

    monkeypatch.chdir(tmp_path)
    trace, metrics = tmp_path / "o" / "trace.json", tmp_path / "o" / "m.jsonl"
    done = serve.main(["--device", "cpu", "--requests", "30", "--batch-size", "8",
                       "--trace", str(trace), "--metrics-out", str(metrics),
                       "--replan-interval", "10", "--replan-budget-mb", "0.25"])
    out = capsys.readouterr().out
    assert len(done) == 30
    assert f"replan: every 10 requests, budget {int(0.25 * 2 ** 20)} B" in out
    assert "windows checked" in out and "stages (mean/wave)" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e["name"] == "wave" for e in events) > 0
    names = {json.loads(line)["name"] for line in metrics.read_text().splitlines()}
    assert {"serve_stage_seconds", "serve_requests_total", "serve_cache_stat"} <= names
    with pytest.raises(SystemExit, match="single-host .* drop --mesh-devices"):
        serve.main(["--device", "cpu", "--replan-interval", "5", "--mesh-devices", "2"])
    with pytest.raises(SystemExit, match="run it under torchrun"):
        serve.main(["--device", "cpu", "--mesh-devices", "2"])


def test_drift_bench_runs_with_its_checks_on_the_cpu(tmp_path, monkeypatch):
    """The reference's five lanes at its sizes with a few recovery steps;
    the p99 bound is a timing check, held on fixed reports (a loaded CPU
    can stall one wave past it), and the checks flag what the reference's
    flag."""
    import json

    from benchmarks import drift_bench as jbench
    from repro_torch.benchmarks import drift_bench

    report = drift_bench.bench(6, 2, 192, device="cpu")
    assert report["fires_stationary"] == 0 and report["fires_drift"] >= 1
    assert report["swap_window"] is not None and report["replans"]
    assert [n for n, _ in drift_bench.check(report) if n != "p99_through_swap_bounded"] == []
    assert report["waves_timed"] == (drift_bench.STAT_WINDOWS + drift_bench.DRIFT_WINDOWS) * 2 \
        * 192 // drift_bench.MAX_BATCH
    fixed = dict(report, p99_ms_swap=1.0, p99_ms_noswap=1.0)
    bad = dict(fixed, fires_stationary=1, fires_drift=0, replans=[], p99_ms_swap=100.0,
               warm_first=2.0, warm_mean=2.0, collision_scale=0.0)
    assert drift_bench.check(bad) == jbench.check(bad) and len(drift_bench.check(bad)) == 7
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(drift_bench, "bench", lambda *a: fixed)
    assert drift_bench.main(["--device", "cpu"]) == 0
    written = json.loads((tmp_path / "artifacts" / "bench_torch" / "BENCH_drift.json")
                         .read_text())
    assert written["acceptance"]["all_checks_passed"] and written["checks_failed"] == []
    assert (tmp_path / "artifacts" / "bench_torch" / "drift_recovery.csv").exists()
    assert not list(tmp_path.glob("BENCH_*.json"))
    monkeypatch.setattr(drift_bench, "bench", lambda *a: bad)
    assert drift_bench.main(["--device", "cpu"]) == 1


# ------------------------------------------------ a migrated plan's routing


def test_mixed_radix_tables_pool_beside_one_grouped_launch(monkeypatch):
    """A re-solved plan may hold mixed-radix tables, which the grouped
    serving kernel does not take: they pool through ``bag_pool`` while one
    grouped launch takes every other table, and the features equal the
    per-table route's and the JAX engine's."""
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm as tdlrm

    rng = np.random.default_rng(9)
    stats = [_stats_of(np.floor(rng.random(4000) ** 0.7 * s), s, JStats) for s in SIZES]
    jplan = jbuild_plan(stats, 8, full_table_bytes(SIZES, 8) // 4, arch="t", dims=(4, 8))
    kinds = [t.kind for t in jplan.tables]
    assert "mixed_radix" in kinds and set(kinds) - {"mixed_radix"}
    jcfg, tcfg = _cfgs(jplan, use_kernel=True)
    jp = jquant(jax_dlrm_init(jax.random.PRNGKey(0), jcfg), mode="int8")
    tp = _tp(jp)
    calls = []
    real = ops.serve_bag_pool_grouped
    monkeypatch.setattr(ops, "serve_bag_pool_grouped",
                        lambda idx, mask, specs: calls.append(len(specs)) or real(idx, mask,
                                                                                    specs))
    idx = torch.from_numpy(np.stack([rng.integers(0, s, (16, 3)) for s in SIZES], 1))
    mask = torch.from_numpy((rng.random((16, len(SIZES), 3)) > 0.3).astype(np.float32))
    got = tdlrm.embed_features(tp["tables"], idx, tcfg, mask=mask, proj=tp.get("proj"))
    assert calls == [kinds.count("full") + kinds.count("qr") + kinds.count("hash")]
    plain = tdlrm.embed_features(tp["tables"], idx, dataclasses.replace(tcfg, use_kernel=False),
                                 mask=mask, proj=tp.get("proj"))
    torch.testing.assert_close(got, torch.stack(plain, 1), rtol=0, atol=0)
    reqs = _requests(np.random.default_rng(1), 24)
    jeng = JaxEngine(jcfg, jp, max_batch=8)
    teng = RecsysEngine(tcfg, tp, max_batch=8, device="cpu")
    np.testing.assert_allclose(_serve(teng, reqs), _serve(jeng, reqs), rtol=0, atol=1e-4)
