"""The grouped lookups: K4 ``fused_serve_pool_grouped``, K1
``qr_gather_grouped`` and K5 ``qr_gather_quant_grouped`` look up every
table of a wave or batch in one launch, splitting raw ids by each table's
``m`` inside the kernel.

Their plain versions are held against the reference's per-table Pallas
kernels in interpret mode, fed the ids split as the reference's ``ops``
splits them, over ragged table sizes (every ``m_t`` differs) and the ids
``0``, ``m_t - 1``, ``m_t`` and ``size_t - 1``.  ``embed_features``'s
grouped route is held against its per-table route, and the launcher's
checks against what the kernel does not take.  The CUDA kernel is held
against the plain versions and against per-table launches in
``test_torch_gpu.py``.

Tolerances: f32 and int8 outputs 1e-5 (both sides sum in f32, in another
order); bf16 outputs 3e-2 (one rounding of the pooled bag to bf16,
``tests/test_kernels.py:12``); the two routes of the port 0 (the same
plain arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qr_gather import qr_gather as jax_qr_gather
from repro.kernels.qr_gather import qr_gather_quant as jax_qr_gather_quant
from repro.kernels.serve_path import fused_serve_pool as jax_fused_serve_pool
from repro.serve.quantize import quantize_table as jax_quantize_table
from repro_torch.convert import params_from_jax
from repro_torch.core import EmbeddingSpec
from repro_torch.kernels import (dot_interaction, embedding_bag, grouped_lookup, ops, qr_gather,
                                 ref, serve_path)
from repro_torch.models import dlrm as tdlrm
from repro_torch.serve.quantize import quantize_params

TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}
SIZES = (13, 50, 7, 200, 3)           # ragged: every m_t = ceil(size / 4) differs
KINDS = ("qr", "qr", "hash", "full", "qr")
OPS = ("mult", "add", "mult", "mult", "add")


def _t(x):
    return params_from_jax(np.asarray(x), device="cpu")


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


def _table(rng, rows, d, mode):
    """(jax table, jax meta or None, port (w, scale, zp))."""
    w = rng.normal(size=(rows, d)).astype(np.float32)
    if mode == "int8":
        q = jax_quantize_table(jnp.asarray(w))
        meta = jnp.concatenate([q["scale"].astype(jnp.float32), q["zp"].astype(jnp.float32)],
                               axis=1)
        return q["q"], meta, (_t(q["q"]), _t(q["scale"]), _t(q["zp"]))
    jw = jnp.asarray(w, jnp.bfloat16 if mode == "bf16" else jnp.float32)
    return jw, None, (_t(jw), None, None)


def _group(rng, d, mode, proj_to=None, kinds=KINDS, ops_=OPS):
    """Per table: (jax operands, port GroupTable)."""
    out = []
    for size, kind, op in zip(SIZES, kinds, ops_):
        proj = None if proj_to is None else rng.normal(size=(d, proj_to)).astype(np.float32)
        if kind == "qr":
            m = -(-size // 4)
            ja, ma, (a, sa, za) = _table(rng, m, d, mode)
            jb, mb, (b, sb, zb) = _table(rng, -(-size // m), d, mode)
        else:
            m = max(1, size // 3) if kind == "hash" else 0
            ja, ma, (a, sa, za) = _table(rng, m or size, d, mode)
            jb = mb = b = sb = zb = None
        tp = None if proj is None else torch.from_numpy(proj)
        out.append(((ja, jb, ma, mb, proj, m, kind, op),
                    ref.GroupTable(a, b, sa, za, sb, zb, m, op, tp)))
    return out


def _ids(rng, b, length):
    """(B, T, L) raw ids in range, with 0, m-1, m and size-1 of every table."""
    idx = np.stack([rng.integers(0, s, size=(b, length)) for s in SIZES], axis=1)
    for t, s in enumerate(SIZES):
        m = -(-s // 4)
        for k, v in enumerate((0, m - 1, min(m, s - 1), s - 1)):
            if length:
                idx[k % b, t, k % length] = v
    return idx.astype(np.int32)


def _jax_pool(jops, idx, mask):
    """The reference's per-table K4 (interpret mode) on ids split as its
    ``ops`` splits them, stacked."""
    ja, jb, ma, mb, proj, m, kind, op = jops
    if kind == "qr":
        ia, ib = idx % m, idx // m
    else:
        ia, ib = (idx % m if kind == "hash" else idx), None
    return jax_fused_serve_pool(
        jnp.asarray(ia), jnp.asarray(mask), ja, idx_b=None if ib is None else jnp.asarray(ib),
        w_b=jb, meta_a=ma, meta_b=mb, proj=None if proj is None else jnp.asarray(proj),
        op=op, interpret=True)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("length", [0, 1, 4])
@pytest.mark.parametrize("d", [16, 24])
def test_grouped_pool_plain_matches_reference(mode, length, d):
    """QR mult and add pairs, a hash and a full table in one group; at
    D=24 every table projects to 16 (mixed width); empty bags; L=0."""
    b = 6
    rng = np.random.default_rng(100 * d + 10 * length + len(mode))
    group = _group(rng, d, mode, proj_to=16 if d == 24 else None)
    idx = _ids(rng, b, length)
    mask = (rng.random((b, len(SIZES), length)) > 0.3).astype(np.float32)
    mask[b - 1] = 0.0                                      # every bag of a request empty
    tables = [g[1] for g in group]
    got = ref.fused_serve_pool_grouped(torch.from_numpy(idx), torch.from_numpy(mask), tables)
    want = [_jax_pool(g[0], idx[:, t], mask[:, t]) for t, g in enumerate(group)]
    assert tuple(got.shape) == (b, len(SIZES), 16)
    for t, w in enumerate(want):
        assert str(got.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(_np(got[:, t]), _np(w), rtol=TOL[mode], atol=TOL[mode],
                                   err_msg=f"table {t}")
    np.testing.assert_array_equal(_np(got[b - 1]), 0.0)
    # the wrapper takes the plain version for CPU tensors
    wrapped = serve_path.fused_serve_pool_grouped(torch.from_numpy(idx),
                                                  torch.from_numpy(mask), tables)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_grouped_pool_without_mask_weighs_every_slot():
    rng = np.random.default_rng(3)
    tables = [g[1] for g in _group(rng, 16, "int8")]
    idx = torch.from_numpy(_ids(rng, 5, 3))
    ones = torch.ones(idx.shape)
    torch.testing.assert_close(ref.fused_serve_pool_grouped(idx, None, tables),
                               ref.fused_serve_pool_grouped(idx, ones, tables), rtol=0, atol=0)


@pytest.mark.parametrize("op", ["mult", "add"])
@pytest.mark.parametrize("d", [16, 24])
def test_grouped_quant_plain_matches_reference(op, d):
    b = 16
    rng = np.random.default_rng(7 + d)
    group = _group(rng, d, "int8", kinds=("qr",) * len(SIZES), ops_=(op,) * len(SIZES))
    idx = _ids(rng, b, 1)[:, :, 0]
    tables = [g[1] for g in group]
    got = ref.qr_gather_quant_grouped(torch.from_numpy(idx), tables)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, len(SIZES), d)
    for t, ((ja, jb, ma, mb, _, m, _, _), _) in enumerate(group):
        want = jax_qr_gather_quant(jnp.asarray(idx[:, t] % m), jnp.asarray(idx[:, t] // m),
                                   ja, jb, ma, mb, op=op, interpret=True)
        np.testing.assert_allclose(_np(got[:, t]), _np(want), rtol=TOL["int8"],
                                   atol=TOL["int8"], err_msg=f"table {t}")
    wrapped = qr_gather.qr_gather_quant_grouped(torch.from_numpy(idx), tables)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["mult", "add"])
@pytest.mark.parametrize("d", [16, 24])
def test_grouped_qr_gather_plain_matches_reference(mode, op, d):
    """Dense QR pairs of ragged sizes, one dtype: table by table equal to
    the reference's K1 (interpret mode) on the ids split as its ``ops``
    splits them, output in the table dtype."""
    b = 16
    rng = np.random.default_rng(11 + d + len(mode) + len(op))
    group = _group(rng, d, mode, kinds=("qr",) * len(SIZES), ops_=(op,) * len(SIZES))
    idx = _ids(rng, b, 1)[:, :, 0]
    tables = [g[1] for g in group]
    got = ref.qr_gather_grouped(torch.from_numpy(idx), tables)
    assert got.dtype == (torch.bfloat16 if mode == "bf16" else torch.float32)
    assert tuple(got.shape) == (b, len(SIZES), d)
    for t, ((ja, jb, _, _, _, m, _, _), _) in enumerate(group):
        want = jax_qr_gather(jnp.asarray(idx[:, t] % m), jnp.asarray(idx[:, t] // m), ja, jb,
                             op=op, interpret=True)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(_np(got[:, t]), _np(want), rtol=TOL[mode], atol=TOL[mode],
                                   err_msg=f"table {t}")
    wrapped = qr_gather.qr_gather_grouped(torch.from_numpy(idx), tables)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    routed = ops.qr_lookup_grouped(torch.from_numpy(idx), [
        (tab.w_a, tab.w_b, 0, tab.op, None) for tab in tables])
    torch.testing.assert_close(routed, got, rtol=0, atol=0)


# ------------------------------------------------- embed_features' routes


def _model(kind, quant, threshold=0):
    """``quant``: False (f32 tables), True (int8), "bf16" (bf16 parameters)
    or "mixed" (the first feature's tables int8, the rest f32)."""
    cfg = tdlrm.DLRMConfig(table_sizes=SIZES, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,),
                           embedding=EmbeddingSpec(kind=kind, num_collisions=4,
                                                   threshold=threshold),
                           use_kernel=True,
                           param_dtype="bfloat16" if quant == "bf16" else "float32")
    params = tdlrm.dlrm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    if quant == "mixed":
        return cfg, quantize_params(params, mode="int8", patterns=(r"^tables/0/",))
    return cfg, quantize_params(params, mode="int8") if quant is True else params


ROUTES = [  # (embedding kind, threshold, tables, one-hot, grouped)
    ("qr", 0, True, False, True), ("qr", 20, False, False, True),    # QR + full tables
    ("hash", 0, True, False, True), ("full", 0, False, False, True),
    ("qr", 0, True, True, True),                                     # one-hot int8: K5
    ("qr", 0, False, True, True),                                    # one-hot f32: K1
    ("qr", 0, "bf16", True, True),                                   # one-hot bf16: K1
    ("qr", 0, "mixed", True, False),                                 # f32 and int8 pairs
    ("qr", 20, True, True, False),                                   # one-hot with a full table
]


@pytest.mark.parametrize("kind,threshold,quant,one_hot,grouped", ROUTES)
def test_embed_features_grouped_route_equals_per_table_route(monkeypatch, kind, threshold,
                                                             quant, one_hot, grouped):
    cfg, params = _model(kind, quant, threshold)
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(_ids(rng, 7, 4))
    mask = torch.from_numpy((rng.random(idx.shape) > 0.3).astype(np.float32))
    args = (idx[:, :, 0], None) if one_hot else (idx, mask)
    got = tdlrm.embed_features(params["tables"], args[0], cfg, mask=args[1])
    assert torch.is_tensor(got) == grouped
    monkeypatch.setattr(tdlrm, "_embed_grouped", lambda *a: None)
    per_table = tdlrm.embed_features(params["tables"], args[0], cfg, mask=args[1])
    assert isinstance(per_table, list)
    got = got if torch.is_tensor(got) else torch.stack(got, dim=1)
    torch.testing.assert_close(got, torch.stack(per_table, dim=1), rtol=0, atol=0)
    if not one_hot:   # multi-hot without a mask weighs every slot on both routes
        monkeypatch.undo()
        full = tdlrm.embed_features(params["tables"], idx, cfg)
        monkeypatch.setattr(tdlrm, "_embed_grouped", lambda *a: None)
        torch.testing.assert_close(full, torch.stack(
            tdlrm.embed_features(params["tables"], idx, cfg), dim=1), rtol=0, atol=0)


def test_grouped_entries_refuse_sets_the_kernel_does_not_take():
    """ops' grouped entries return None, launching nothing, for a concat
    pair, a mixed dense+int8 pair, tables that pool to different dtypes,
    and (one-hot) anything but mult/add pairs all int8 or all dense of one
    dtype."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    q = quantize_params({"tables": [{"table": w}]}, mode="int8")["tables"][0]["table"]
    idx, ids1 = torch.zeros((2, 2, 3), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32)
    proj = torch.eye(16)
    refused = [
        [(w, w, 0, "concat", None), (w, None, 0, "mult", None)],
        [(q, w, 0, "mult", None), (w, None, 0, "mult", None)],
        [(w.bfloat16(), None, 0, "mult", None), (w.bfloat16(), None, 0, "mult", proj)],
    ]
    for specs in refused:
        assert ops.serve_bag_pool_grouped(idx, None, specs) is None
    for specs in ([(w, None, 0, "mult", None)] * 2, [(q, q, 0, "concat", None)] * 2,
                  [(q, q, 0, "mult", proj)] * 2, [(q, None, 0, "mult", None)] * 2,
                  [(w, w, 0, "mult", None), (q, q, 0, "mult", None)],
                  [(w, w, 0, "mult", None), (w.bfloat16(), w.bfloat16(), 0, "mult", None)],
                  [(q, w, 0, "mult", None)] * 2, [(w.double(), w.double(), 0, "add", None)] * 2):
        assert ops.qr_lookup_grouped(ids1, specs) is None
    assert ops.qr_lookup_grouped(ids1, [(q, q, 0, "mult", None)] * 2).dtype == torch.float32
    for dense in (w, w.bfloat16()):
        got = ops.qr_lookup_grouped(ids1, [(dense, dense, 0, "add", None)] * 2)
        assert got.shape == (2, 2, 16) and got.dtype == dense.dtype
    assert ops.serve_bag_pool_grouped(idx, None, refused[2][:1] * 2).dtype == torch.bfloat16


# ------------------------------------------------- the launcher's checks


def _bad_launches():
    """(what, launch kwargs) the kernel does not take; the checks run
    before anything is built or launched."""
    rng = np.random.default_rng(9)
    f32 = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    q = quantize_params({"tables": [{"table": f32}]}, mode="int8")["tables"][0]["table"]
    pair = ref.GroupTable(q["q"], q["q"], q["scale"], q["zp"], q["scale"], q["zp"], 8)
    dense = ref.GroupTable(f32)
    idx = torch.zeros((4, 2, 3), dtype=torch.int32)
    one = torch.zeros((4, 2), dtype=torch.int32)
    narrow = ref.GroupTable(f32[:, :8].contiguous())
    return {
        "widths": (idx, [dense, narrow], True),
        "dtypes": (idx, [dense, ref.GroupTable(f32.bfloat16())], True),
        "cap": (torch.zeros((4, grouped_lookup.MAX_TABLES + 1, 3), dtype=torch.int32),
                [dense] * (grouped_lookup.MAX_TABLES + 1), True),
        "no tables": (torch.zeros((4, 0, 3), dtype=torch.int32), [], True),
        "ids vs tables": (idx, [dense], True),
        "one-hot dense": (one, [dense, dense], False),
        "one-hot projected pair": (one, [pair._replace(proj=torch.eye(16))] * 2, False),
        "one-hot mixed pair": (one, [pair._replace(w_b=f32, scale_b=None, zp_b=None)] * 2,
                               False),
        "concat": (idx, [pair._replace(op="concat")] * 2, True),
        "pair without m": (idx, [pair._replace(m=0)] * 2, True),
        "int8 without zp": (idx, [pair._replace(zp_a=None)] * 2, True),
        "proj width": (idx, [dense._replace(proj=torch.eye(8))] * 2, True),
        "strided table": (idx, [ref.GroupTable(f32.t())] * 2, True),
    }


@pytest.mark.parametrize("what", list(_bad_launches()))
def test_launcher_refuses_what_the_kernel_does_not_take(what, monkeypatch):
    idx, tables, bag = _bad_launches()[what]

    def no_build(name):
        raise AssertionError("the checks must refuse before any build")

    monkeypatch.setattr(grouped_lookup._build, "library", no_build)
    with pytest.raises(ValueError):
        grouped_lookup.launch(serve_path.fused_serve_pool, "grouped", idx, None, tables,
                              bag=bag)


def _bad_bag_pairs():
    """Launches K3's one-pair entry must refuse: (idx, mask, w_a, w_b, m, idx_b)."""
    f32 = torch.zeros((8, 16))
    ids, mask = torch.zeros((4, 3), dtype=torch.int32), torch.ones((4, 3))
    q = quantize_params({"tables": [{"table": f32}]}, mode="int8")["tables"][0]["table"]["q"]
    return {
        "ids not (B, L)": (ids[:, :, None], mask[:, :, None], f32, f32, 8, None),
        "mask shape": (ids, mask[:, :2], f32, f32, 8, None),
        "int8 pair": (ids, mask, q, q, 8, None),
        "mixed dtypes": (ids, mask, f32, f32.bfloat16(), 8, None),
        "single table": (ids, mask, f32, None, 8, None),
        "widths differ": (ids, mask, f32, torch.zeros((2, 8)), 8, None),
        "strided table": (ids, mask, f32.t(), f32.t(), 8, None),
        "raw ids without m": (ids, mask, f32, f32, 0, None),
        "pre-split ids with m": (ids, mask, f32, f32, 8, ids),
        "pre-split ids differ": (ids, mask, f32, f32, 0, ids[:, :2]),
    }


@pytest.mark.parametrize("what", list(_bad_bag_pairs()))
def test_launcher_refuses_k3_tables_that_are_not_dense_pairs(what, monkeypatch):
    """K3's launch (``launch_bag_pair``) takes one dense f32 / bf16 QR pair
    and (B, L) ids and mask alike, and keeps only the checks that case
    needs; the refusal comes before anything is built."""
    idx, mask, w_a, w_b, m, idx_b = _bad_bag_pairs()[what]

    def no_build(name):
        raise AssertionError("the checks must refuse before any build")

    monkeypatch.setattr(grouped_lookup._build, "library", no_build)
    with pytest.raises(ValueError, match="k3"):
        grouped_lookup.launch_bag_pair(embedding_bag.qr_embedding_bag, "k3", idx, mask, w_a,
                                       w_b, m=m, op="mult", idx_b=idx_b)
    with pytest.raises(ValueError, match="mult or add"):
        grouped_lookup.launch_bag_pair(embedding_bag.qr_embedding_bag, "k3", *_bad_bag_pairs()[
            "raw ids without m"][:4], m=8, op="concat")


def test_launch_counts_go_to_the_per_table_counters():
    """The grouped entries count on their per-table kernel's counter; on
    the CPU nothing launches and nothing is counted."""
    rng = np.random.default_rng(4)
    tables = [g[1] for g in _group(rng, 16, "int8", kinds=("qr",) * 5, ops_=("mult",) * 5)]
    dense = [g[1] for g in _group(rng, 16, "f32", kinds=("qr",) * 5, ops_=("mult",) * 5)]
    counters = (serve_path.fused_serve_pool, qr_gather.qr_gather_quant, qr_gather.qr_gather)
    before = [c.launches for c in counters]
    serve_path.fused_serve_pool_grouped(torch.from_numpy(_ids(rng, 3, 2)), None, tables)
    qr_gather.qr_gather_quant_grouped(torch.from_numpy(_ids(rng, 3, 1)[:, :, 0]), tables)
    qr_gather.qr_gather_grouped(torch.from_numpy(_ids(rng, 3, 1)[:, :, 0]), dense)
    assert [c.launches for c in counters] == before
    for grouped in (serve_path.fused_serve_pool_grouped, qr_gather.qr_gather_quant_grouped,
                    qr_gather.qr_gather_grouped):
        assert not hasattr(grouped, "launches")


# ------------------------------------------------ over the cap, and grad mode


@pytest.mark.parametrize("one_hot", [True, False])
def test_grouped_entries_split_more_tables_than_one_launch_takes(one_hot):
    """41 tables (one over ``MAX_TABLES``) go through ``ops``' grouped
    entries in launches of at most 40, split the same way on every
    device: the result equals the per-table route, f32 and int8."""
    rng = np.random.default_rng(11)
    n = grouped_lookup.MAX_TABLES + 1
    sizes = rng.integers(5, 300, size=n)
    dense = [(torch.from_numpy(rng.normal(size=(-(-int(s) // 4), 16)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))) for s in sizes]
    length = 1 if one_hot else 3
    idx = torch.from_numpy(np.stack([rng.integers(0, s, size=(9, length)) for s in sizes],
                                    axis=1).astype(np.int32))
    mask = torch.from_numpy((rng.random(idx.shape) > 0.3).astype(np.float32))
    for quant in (False, True):
        pairs = [quantize_params({"tables": [{"table_0": a, "table_1": b}]},
                                 mode="int8")["tables"][0] if quant else
                 {"table_0": a, "table_1": b} for a, b in dense]
        specs = [(p["table_0"], p["table_1"], 0, "mult", None) for p in pairs]
        if one_hot:
            got = ops.qr_lookup_grouped(idx[:, :, 0], specs)
            want = torch.stack([ops.qr_lookup(idx[:, t, 0], p["table_0"], p["table_1"],
                                              use_kernel=False) for t, p in enumerate(pairs)],
                               dim=1)
        else:
            got = ops.serve_bag_pool_grouped(idx, mask, specs)
            want = torch.stack([ops.serve_bag_pool(idx[:, t], mask[:, t], p["table_0"],
                                                   p["table_1"], use_kernel=False)
                                for t, p in enumerate(pairs)], dim=1)
        assert got.shape == (9, n, 16)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_launch_points_refuse_operands_that_require_grad(monkeypatch):
    """The kernels have no backward: each launch point raises when grad
    mode is on and an operand requires grad, before anything is built, and
    goes on to the launch under ``torch.no_grad()``."""
    calls = []

    def no_build(name):
        calls.append(name)
        raise LookupError("reached the build")

    monkeypatch.setattr(grouped_lookup._build, "library", no_build)
    w = torch.randn((8, 16), requires_grad=True)
    ids = torch.zeros((4, 2), dtype=torch.int32)
    z, feats = torch.randn((4, 16), requires_grad=True), torch.randn((4, 3, 16))
    launches = {
        "grouped": lambda: grouped_lookup.launch(qr_gather.qr_gather, "grouped", ids, None,
                                                 [ref.GroupTable(w, w.detach(), m=8)] * 2,
                                                 bag=False),
        "grouped mask": lambda: grouped_lookup.launch(
            serve_path.fused_serve_pool, "grouped", ids[:, :, None],
            torch.ones((4, 2, 1), requires_grad=True), [ref.GroupTable(w.detach())] * 2,
            bag=True),
        "bag pair": lambda: grouped_lookup.launch_bag_pair(
            embedding_bag.qr_embedding_bag, "k3", ids, torch.ones((4, 2)), w.detach(), w,
            m=8, op="mult"),
        "interaction": lambda: dot_interaction._launch(
            "k2", z, feats, torch.empty((4, 16 + 6)), 16),
    }
    for launch in launches.values():
        with pytest.raises(RuntimeError, match="requires grad"):
            launch()
        with torch.no_grad(), pytest.raises(LookupError):
            launch()
    assert calls == ["grouped_lookup"] * 3 + ["dot_interaction"]
