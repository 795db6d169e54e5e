"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same card inputs, the kernel route through
``ops``, the serving engine and the one-hot scoring route, and the
launcher's default device.

Every test here carries the ``gpu`` marker and skips without a card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only the port's dependencies:
``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: f32 and int8 outputs 1e-5 (both sides sum in f32, in another
order); bf16 outputs 3e-2 (one final rounding to bf16); engine scores and
logits 1e-4 (f32 summation order through pooling, interaction and two
MLPs).  The f32-accumulation audit holds a bf16 bag at L=16, D=128 to
rtol 5e-3 against an f32 oracle (``tests/test_kernels.py:84-107``).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import dlrm_criteo
from repro_torch.configs.common import Shape
from repro_torch.core import EmbeddingSpec
from repro_torch.kernels import (dot_interaction, embedding_bag, grouped_lookup, ops, qr_gather,
                                 ref, serve_path)
from repro_torch.launch import serve as launch_serve
from repro_torch.models.dlrm import DLRMConfig, dlrm_forward, dlrm_init
from repro_torch.serve.cache import DeviceHotRowCache, RowRef
from repro_torch.serve.quantize import quantize_params, quantize_table
from repro_torch.serve.recsys import RecsysEngine

TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}

pytestmark = pytest.mark.gpu

# cuBLAS reads this when it makes its first handle, so before any test runs:
# the deterministic restart test needs it (and checks for it).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tables(rng, rows_a, rows_b, d, mode, device):
    wa = torch.from_numpy(rng.normal(size=(rows_a, d)).astype(np.float32)).to(device)
    wb = torch.from_numpy(rng.normal(size=(rows_b, d)).astype(np.float32)).to(device)
    if mode == "int8":
        qa, qb = quantize_table(wa), quantize_table(wb)
        return dict(w_a=qa["q"], w_b=qb["q"], scale_a=qa["scale"], zp_a=qa["zp"],
                    scale_b=qb["scale"], zp_b=qb["zp"])
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    return dict(w_a=wa.to(dt), w_b=wb.to(dt))


def _pool(fn, ia, mk, t, ib, proj, op):
    pair = ib is not None
    return fn(ia, mk, t["w_a"], ib, t["w_b"] if pair else None, t.get("scale_a"),
              t.get("zp_a"), t.get("scale_b") if pair else None,
              t.get("zp_b") if pair else None, proj, op=op)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_serve_pool_kernel_matches_plain(cuda, mode):
    """K4 over pair/single, mult/add, projection, empty bags and L=0."""
    for length in (0, 1, 4, 16):
        for d, d_out in ((16, None), (64, 128), (128, None)):
            rng = np.random.default_rng(length * 7 + d)
            t = _tables(rng, 1000, 40, d, mode, cuda)
            idx = rng.integers(0, 40_000, size=(37, length)).astype(np.int32)
            mask = (rng.random((37, length)) > 0.3).astype(np.float32)
            mask[-1] = 0.0                                  # an empty bag
            ia = torch.from_numpy(idx % 1000).to(cuda)
            ib = torch.from_numpy(idx // 1000).to(cuda)
            mk = torch.from_numpy(mask).to(cuda)
            proj = None if d_out is None else torch.from_numpy(
                rng.normal(size=(d, d_out)).astype(np.float32)).to(cuda)
            for pair in (True, False):
                for op in ("mult", "add"):
                    before = serve_path.fused_serve_pool.launches
                    args = (ia, mk, t, ib if pair else None, proj, op)
                    got = _pool(serve_path.fused_serve_pool, *args)
                    want = _pool(ref.fused_serve_pool, *args)
                    torch.cuda.synchronize()
                    assert serve_path.fused_serve_pool.launches == before + 1
                    assert got.dtype == want.dtype and got.shape == want.shape
                    tol = TOL["bf16" if mode == "bf16" else "f32"]
                    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
                    assert (got[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interaction_kernel_matches_plain(cuda, dtype):
    tol = TOL["f32" if dtype == torch.float32 else "bf16"]
    for b, f, d in ((4, 27, 16), (13, 5, 32), (1, 3, 8), (256, 27, 16), (3, 2, 1),
                    (7, 40, 128)):
        x = torch.from_numpy(np.random.default_rng(b).normal(size=(b, f, d))).to(cuda, dtype)
        before = dot_interaction.dot_interaction.launches
        got = dot_interaction.dot_interaction(x)
        want = ref.dot_interaction(x)
        torch.cuda.synchronize()
        assert dot_interaction.dot_interaction.launches == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _interaction_cases(dtype, cuda):
    """(name, z, feats) at the shapes the chip smoke holds K2 at: DLRM's
    F=27, D=16 at B=256; ragged F (2, 33), D (24, 128) and B (1, 257);
    z and feats as strided views of one buffer, and as transposed views
    whose last dimension is not contiguous."""
    rng = np.random.default_rng(int(dtype == torch.bfloat16))
    cases = []
    for b, f, d in ((256, 27, 16), (257, 2, 24), (1, 33, 128), (257, 33, 24), (3, 2, 128)):
        x = torch.from_numpy(rng.normal(size=(b, f, d))).to(cuda, dtype)
        cases.append((f"B={b} F={f} D={d}", x[:, 0].contiguous(), x[:, 1:].contiguous()))
        cases.append((f"B={b} F={f} D={d} views", x[:, 0], x[:, 1:]))
    xt = torch.from_numpy(rng.normal(size=(5, 16, 27))).to(cuda, dtype).transpose(1, 2)
    cases.append(("B=5 F=27 D=16 transposed", xt[:, 0], xt[:, 1:]))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("examples", [1, 2, 4, 8])
def test_interaction_kernel_reads_z_and_feats_in_place(cuda, dtype, examples, monkeypatch):
    """Both K2 entries at every examples-per-block setting: the top MLP's
    input ``[z, triangle]`` from z and feats as given (strided and
    transposed views included), and ``dot_interaction(x)`` on the stacked
    x, each one launch, within tolerance of the plain versions, and the
    z columns copied exactly."""
    monkeypatch.setattr(dot_interaction, "EXAMPLES_PER_BLOCK", examples)
    tol = TOL["f32" if dtype == torch.float32 else "bf16"]
    for name, z, feats in _interaction_cases(dtype, cuda):
        got = _launched_on(dot_interaction.dot_interaction,
                                dot_interaction.dot_interaction_concat, z, feats)
        want = ref.dot_interaction_concat(z, feats)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol, msg=name)
        assert torch.equal(got[:, :z.shape[1]], z), name
        x = torch.cat([z[:, None], feats], dim=1)
        tri = _launched(dot_interaction.dot_interaction, x)
        assert torch.equal(tri, got[:, z.shape[1]:]), name


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    rng = np.random.default_rng(3)
    t = _tables(rng, 12, 4, 16, "int8", cuda)
    qa = {"q": t["w_a"], "scale": t["scale_a"], "zp": t["zp_a"]}
    qb = {"q": t["w_b"], "scale": t["scale_b"], "zp": t["zp_b"]}
    idx = torch.from_numpy(rng.integers(0, 48, size=(5, 3))).to(cuda)
    mask = torch.ones((5, 3), device=cuda)
    before = serve_path.fused_serve_pool.launches
    got = ops.serve_bag_pool(idx, mask, qa, qb)
    want = ops.serve_bag_pool(idx, mask, qa, qb, use_kernel=False)
    assert serve_path.fused_serve_pool.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    x = torch.randn((8, 4, 16), device=cuda)
    before = dot_interaction.dot_interaction.launches
    ops.dlrm_interact(x)
    assert dot_interaction.dot_interaction.launches == before + 1


@pytest.mark.parametrize("batching", ["continuous", "waves"])
def test_engine_on_card_kernels_match_plain_route(cuda, batching):
    sizes = (100, 500, 33, 10_000)
    cfg = DLRMConfig(table_sizes=sizes, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,),
                     embedding=EmbeddingSpec(kind="qr", num_collisions=4), use_kernel=True)
    params = quantize_params(dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0),
                                       cuda))
    rng = np.random.default_rng(0)
    reqs = list(launch_serve.request_stream(rng, sizes, 13, 40, 4))
    reqs[3] = (reqs[3][0], [[] for _ in sizes])
    scores = {}
    for use_kernel in (True, False):
        eng = RecsysEngine(dataclasses.replace(cfg, use_kernel=use_kernel), params,
                           max_batch=8, batching=batching)
        k4, k2 = serve_path.fused_serve_pool.launches, dot_interaction.dot_interaction.launches
        uids = [eng.submit(d, b) for d, b in reqs]
        done = eng.run_until_drained()
        scores[use_kernel] = np.array([done[u].score for u in uids])
        waves = eng.metrics()["waves"]
        launched = (serve_path.fused_serve_pool.launches - k4,
                    dot_interaction.dot_interaction.launches - k2)
        assert launched == ((waves, waves) if use_kernel else (0, 0))   # one K4 per wave
    assert np.isfinite(scores[True]).all()
    np.testing.assert_allclose(scores[True], scores[False], rtol=0, atol=1e-4)


def test_launcher_serves_on_card_by_default(cuda, capsys):
    done = launch_serve.main(["--requests", "16", "--batch-size", "8"])
    assert len(done) == 16 and all(np.isfinite(r.score) for r in done.values())
    assert "served 16 requests" in capsys.readouterr().out


def test_device_cache_slab_scatter_and_read_back_on_card(cuda):
    """Rows admitted by reference (one gather of a block) and as tensors
    land in the card's slab, deduped last-write-wins, and read back
    exactly; the slab is preallocated on the card."""
    cache = DeviceHotRowCache(capacity_rows=100, device=cuda)
    block = torch.arange(40 * 16, dtype=torch.float32, device=cuda).reshape(40, 16)
    keys = list(range(0, 80, 2))
    assert cache.put_many(keys, [RowRef(block, j) for j in range(40)]) == keys
    assert cache.slab(16).device.type == "cuda" and cache.slab(16).shape == (100, 16)
    for k, j in ((0, 0), (38, 19), (78, 39)):
        np.testing.assert_array_equal(cache.get(k), block[j].cpu().numpy())
    one = DeviceHotRowCache(capacity_rows=1, device=cuda)
    one.put_many([10, 11], torch.stack([torch.full((4,), 1.0), torch.full((4,), 2.0)]))
    np.testing.assert_array_equal(one.get(11), np.full(4, 2.0, np.float32))
    slots, miss = cache.lookup_many(keys + [1], np.ones(41, np.int64))
    assert (slots[:40] >= 0).all() and miss.tolist() == [False] * 40 + [True]


def _cache_engine_scores(cfg, params, reqs, cache):
    eng = RecsysEngine(cfg, params, max_batch=16, cache=cache)
    uids = [eng.submit(d, b) for d, b in reqs]
    done = eng.run_until_drained()
    uids += [eng.submit(d, b) for d, b in reqs]           # the same again: hits
    done = eng.run_until_drained()
    return np.array([done[u].score for u in uids]), eng.metrics()


@pytest.mark.parametrize("path", ["fast", "exact", "ingraph"])
def test_engine_cache_paths_on_card_match_cache_off(cuda, path):
    """Each cache branch on the card (the speculative probe, the exact
    host lookup, and a refused admission served in-graph) against cache
    off: within 1e-4 (slab pool vs K4's order), equal in-graph; one K2 per
    dense stage and K4 only where the tables served the wave."""
    sizes = (100, 500, 33, 10_000)
    cfg = DLRMConfig(table_sizes=sizes, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,),
                     embedding=EmbeddingSpec(kind="qr", num_collisions=4), use_kernel=True)
    params = quantize_params(dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0),
                                       cuda))
    reqs = list(launch_serve.request_stream(np.random.default_rng(1), sizes, 13, 48, 4))
    reqs[5] = (reqs[5][0], [[] for _ in sizes])
    off, _ = _cache_engine_scores(cfg, params, reqs, None)
    cache = DeviceHotRowCache(capacity_rows=2 if path == "ingraph" else 4096,
                              record_events=path == "exact", device=cuda)
    k4, k2 = serve_path.fused_serve_pool.launches, dot_interaction.dot_interaction.launches
    on, m = _cache_engine_scores(cfg, params, reqs, cache)
    paths = m["cache_paths"]
    assert paths[path] > 0 and (m["cache"]["hit_rate"] > 0 or path == "ingraph")
    assert (serve_path.fused_serve_pool.launches - k4,
            dot_interaction.dot_interaction.launches - k2) == \
        (paths["ingraph"], m["waves"] + paths["probe_missed"])
    assert np.isfinite(on).all()
    if path == "ingraph":
        np.testing.assert_array_equal(on, off)
    else:
        np.testing.assert_allclose(on, off, rtol=0, atol=1e-4)


def test_engine_refuses_a_host_cache_device_on_card(cuda):
    cfg = DLRMConfig(table_sizes=(100,), emb_dim=16, bottom_mlp=(16,), top_mlp=(16,),
                     embedding=EmbeddingSpec(kind="qr", num_collisions=4))
    params = dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    with pytest.raises(ValueError, match="device"):
        RecsysEngine(cfg, params, cache=DeviceHotRowCache(8, device="cpu"))
    cache = DeviceHotRowCache(8, device="cuda:0")         # the card "cuda" means
    assert RecsysEngine(cfg, params, cache=cache).cache is cache


def _launched(kernel, *args, **kw):
    """``kernel(*args, **kw)``, checking that it launched once."""
    before = kernel.launches
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_qr_gather_kernels_match_plain(cuda, mode):
    """K1 (f32, bf16) and K5 (int8) over the reference's sweep shapes
    (``tests/test_kernels.py:23-24``), mult and add, and N = 0."""
    for m, q, d, n in ((7, 3, 16, 5), (128, 8, 128, 64), (33, 5, 256, 17),
                       (1000, 4, 32, 200), (7, 3, 16, 0)):
        rng = np.random.default_rng(m + d + n)
        t = _tables(rng, m, q, d, mode, cuda)
        idx = rng.integers(0, m * q, size=(n,))
        rem = torch.from_numpy(idx % m).to(cuda)
        quo = torch.from_numpy(idx // m).to(cuda)
        for op in ("mult", "add"):
            if mode == "int8":
                args = (rem, quo, t["w_a"], t["w_b"], t["scale_a"], t["zp_a"], t["scale_b"],
                        t["zp_b"])
                kernel, plain = qr_gather.qr_gather_quant, ref.qr_gather_quant
            else:
                args = (rem, quo, t["w_a"], t["w_b"])
                kernel, plain = qr_gather.qr_gather, ref.qr_gather
            if n == 0:
                assert kernel(*args, op=op).shape == (0, d)
                continue
            got = _launched(kernel, *args, op=op)
            want = plain(*args, op=op)
            assert got.dtype == want.dtype and got.shape == want.shape == (n, d)
            tol = TOL["bf16" if mode == "bf16" else "f32"]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_matches_plain(cuda, dtype):
    """K3 over the reference's sweep shapes (``tests/test_kernels.py:35-37``)
    and L = 0, mult and add, fractional weights (rounded to the table dtype
    first) and an empty bag."""
    tol = TOL["f32" if dtype == torch.float32 else "bf16"]
    for b, length, m, q, d in ((4, 3, 11, 4, 16), (8, 16, 64, 8, 128), (3, 7, 29, 5, 64),
                               (256, 4, 1000, 4, 16), (5, 0, 11, 4, 16)):
        rng = np.random.default_rng(b * length + d)
        w_rem = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(cuda, dtype)
        w_quo = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(cuda, dtype)
        idx = rng.integers(0, m * q, size=(b, length))
        weights = rng.choice([0.0, 0.3, 1.0, 1.7], size=(b, length)).astype(np.float32)
        weights[-1] = 0.0                                   # an empty bag
        rem = torch.from_numpy(idx % m).to(cuda)
        quo = torch.from_numpy(idx // m).to(cuda)
        mask = torch.from_numpy(weights).to(cuda)
        for op in ("mult", "add"):
            args = (rem, quo, mask, w_rem, w_quo)
            got = _launched(embedding_bag.qr_embedding_bag, *args, op=op)
            want = ref.qr_embedding_bag(*args, op=op)
            assert got.dtype == dtype and got.shape == want.shape == (b, d)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
            assert (got[-1] == 0).all()


@pytest.mark.parametrize("op", ["mult", "add"])
def test_embedding_bag_kernel_accumulates_f32_at_L16_D128(cuda, op):
    """The audit, on both K3 entries: a bf16 bag at L=16, D=128 within
    rtol 5e-3 of an f32 oracle; control: a bf16 running sum of the same
    rows fails it."""
    rng = np.random.default_rng(10)
    m, q = 64, 8
    # positive rows: no cancellation, so a bf16 running sum's error compounds
    wr = torch.from_numpy(np.abs(rng.normal(size=(m, 128))) + 0.5).to(cuda, torch.bfloat16)
    wq = torch.from_numpy(np.abs(rng.normal(size=(q, 128))) + 0.5).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, m * q, size=(8, 16))).to(cuda)
    mask = torch.ones((8, 16), device=cuda)
    a, b = wr.float()[idx % m], wq.float()[idx // m]
    rows = a * b if op == "mult" else a + b
    want = rows.sum(dim=1)
    for got in (ops.qr_bag_lookup(idx, mask, wr, wq, op=op),
                embedding_bag.qr_embedding_bag(idx % m, idx // m, mask, wr, wq, op=op)):
        torch.testing.assert_close(got.float(), want, rtol=5e-3, atol=0)
    running = torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda)
    for lane in range(16):
        running = running + rows[:, lane].bfloat16()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(running.float(), want, rtol=5e-3, atol=0)


def test_embedding_bag_bf16_weights_round_before_they_multiply(cuda):
    """Three slots of weight 0.3 on rows of 1.0 in a bf16 table: K3 rounds
    the weight to bf16 (0.30078125) first, so the bag is 0.90234375 on
    both entries; with the f32 weight it would round to 0.8984375, which is
    what K4 (whose weights stay f32) gives on the same inputs."""
    ones = torch.ones((4, 8), dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros((1, 3), dtype=torch.int32, device=cuda)
    mask = torch.full((1, 3), 0.3, device=cuda)
    for got in (embedding_bag.qr_embedding_bag(idx, idx, mask, ones, ones),
                ops.qr_bag_lookup(idx, mask, ones, ones)):
        assert got.dtype == torch.bfloat16 and (got.float() == 0.90234375).all()
    k4 = serve_path.fused_serve_pool_grouped(idx[:, None], mask[:, None],
                                             [ref.GroupTable(ones, ones, m=4)])
    assert k4.dtype == torch.bfloat16 and (k4.float() == 0.8984375).all()


def _spy_launches(monkeypatch):
    """Record the arguments of every grouped-kernel launch."""
    calls = []
    real = grouped_lookup._build.library

    class Spy:
        def __init__(self, lib):
            self._lib = lib

        def grouped_lookup(self, *args):
            calls.append(args)
            return self._lib.grouped_lookup(*args)

    monkeypatch.setattr(grouped_lookup._build, "library",
                        lambda name: Spy(real(name)) if name == "grouped_lookup" else real(name))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_embedding_bag_raw_ids_read_in_place(cuda, dtype, id_dtype, monkeypatch):
    """ops.qr_bag_lookup on a dense pair: one K3 launch on the raw ids, the
    ids and the mask read in place through their strides (strided views of
    wider buffers; the kernel gets their own pointers), the edge ids 0,
    m-1, m and size-1, bit-equal to the pre-split per-table entry and
    within tolerance of the plain version; empty bags and L = 0 are zero."""
    calls = _spy_launches(monkeypatch)
    rng = np.random.default_rng(7)
    m, q, d, b, length = 1000, 7, 128, 37, 9
    size = m * q - 3
    w_rem = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(cuda, dtype)
    w_quo = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(cuda, dtype)
    ids = rng.integers(0, size, size=(b, 2 * length))
    ids[:4, 0] = (0, m - 1, m, size - 1)
    weights = rng.choice([0.0, 0.3, 1.0, 1.7], size=(b, 2 * length)).astype(np.float32)
    weights[:4, 0] = 1.0
    weights[-1] = 0.0                                               # an empty bag
    idx = torch.from_numpy(ids).to(cuda, id_dtype)[:, ::2]
    mask = torch.from_numpy(weights).to(cuda)[:, ::2]
    assert not idx.is_contiguous() and not mask.is_contiguous()
    tol = TOL["f32" if dtype == torch.float32 else "bf16"]
    for op in ("mult", "add"):
        del calls[:]
        lookup = functools.partial(ops.qr_bag_lookup, w_rem=w_rem, w_quo=w_quo, op=op)
        got = _launched_on(embedding_bag.qr_embedding_bag, lookup, idx, mask)
        args = calls[0]
        assert len(calls) == 1 and args[3] == idx.data_ptr() and args[9] == mask.data_ptr()
        assert got.dtype == dtype and got.shape == (b, d)
        pre_split = embedding_bag.qr_embedding_bag(idx % m, idx // m, mask, w_rem, w_quo, op=op)
        assert torch.equal(got, pre_split)
        want = ref.qr_embedding_bag(idx % m, idx // m, mask, w_rem, w_quo, op=op)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        assert (got[-1] == 0).all()
        empty = _launched_on(embedding_bag.qr_embedding_bag, lookup, idx[:, :0], mask[:, :0])
        assert empty.shape == (b, d) and (empty == 0).all()


@pytest.mark.parametrize("wide_threads", [8, 16, 32])
def test_embedding_bag_matches_plain_and_per_table_at_any_threads_per_bag(cuda, wide_threads,
                                                                          monkeypatch):
    """K3's raw-id route (``ops.qr_bag_lookup``) over dense QR pairs of
    ragged sizes (mult and add in turn) at D=128 and D=16, f32 and bf16, L
    in {0, 1, 5, 32}, edge ids, fractional weights and empty bags, ids and
    mask read as strided views: one launch each, within tolerance of the
    plain version and bit-equal to the pre-split per-table entry, whatever
    the threads per bag for wide rows."""
    monkeypatch.setattr(grouped_lookup, "WIDE_THREADS_PER_BAG", wide_threads)
    sizes = (13, 50, 7, 1_000_003)
    for mode in ("f32", "bf16"):
        for d in (128, 16):
            for length in (0, 1, 5, 32):
                rng = np.random.default_rng(d + length + len(mode))
                tables = _group(rng, sizes, d, mode, cuda, kinds=("qr",))
                idx = _edge_ids(rng, sizes, 19, length, cuda)
                mask = torch.from_numpy(rng.choice([0.0, 0.3, 1.0, 1.7], size=idx.shape)
                                        .astype(np.float32)).to(cuda)
                mask[-1] = 0.0                              # a request of empty bags
                for t, tab in enumerate(tables):
                    ids, weights = idx[:, t], mask[:, t]
                    lookup = functools.partial(ops.qr_bag_lookup, w_rem=tab.w_a, w_quo=tab.w_b,
                                               op=tab.op)
                    got = _launched_on(embedding_bag.qr_embedding_bag, lookup, ids, weights)
                    want = ref.qr_embedding_bag_raw(ids, weights, tab.w_a, tab.w_b, op=tab.op)
                    assert got.dtype == want.dtype == tab.w_a.dtype
                    assert got.shape == want.shape == (19, d)
                    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[mode],
                                               atol=TOL[mode])
                    assert (got[-1] == 0).all()
                    one = embedding_bag.qr_embedding_bag(ids % tab.m, ids // tab.m, weights,
                                                         tab.w_a, tab.w_b, op=tab.op)
                    assert torch.equal(one, got)


def test_grouped_mixed_group_matches_per_table(cuda):
    """A K4 group that mixes storage types (an int8 QR pair, a full f32
    table, and a projected bf16 pair at D=16 or an f32 pair at D=128) runs
    the kernel that switches per table: within tolerance of the plain
    version and bit-equal to one launch per table, each of which runs its
    own one-case kernel."""
    rng = np.random.default_rng(13)
    for d in (16, 128):
        q8 = _tables(rng, 40, 5, d, "int8", cuda)
        f32 = _tables(rng, 30, 1, d, "f32", cuda)
        tables = [ref.GroupTable(q8["w_a"], q8["w_b"], q8["scale_a"], q8["zp_a"], q8["scale_b"],
                                 q8["zp_b"], 40),
                  ref.GroupTable(f32["w_a"])]
        if d == 16:
            bf = _tables(rng, 8, 3, d, "bf16", cuda)
            proj = torch.from_numpy(0.25 * rng.normal(size=(d, d)).astype(np.float32)).to(cuda)
            tables.append(ref.GroupTable(bf["w_a"], bf["w_b"], m=8, op="add", proj=proj))
        else:
            pair = _tables(rng, 8, 3, d, "f32", cuda)
            tables.append(ref.GroupTable(pair["w_a"], pair["w_b"], m=8, op="add"))
        idx = _edge_ids(rng, (200, 30, 24), 21, 6, cuda)
        mask = torch.from_numpy(rng.choice([0.0, 0.5, 1.0], size=idx.shape)
                                .astype(np.float32)).to(cuda)
        got = _launched_on(serve_path.fused_serve_pool, serve_path.fused_serve_pool_grouped,
                           idx, mask, tables)
        want = ref.fused_serve_pool_grouped(idx, mask, tables)
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=TOL["f32"], atol=TOL["f32"])
        for t, tab in enumerate(tables):
            one = serve_path.fused_serve_pool_grouped(idx[:, t:t + 1], mask[:, t:t + 1], [tab])
            assert torch.equal(one[:, 0], got[:, t])


def test_embedding_bag_refuses_what_k3_does_not_take(cuda):
    """Both K3 entries refuse an int8 pair, tables of two dtypes or widths
    and a strided table, and an op other than mult or add."""
    rng = np.random.default_rng(12)
    t = _tables(rng, 12, 4, 16, "int8", cuda)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    mask = torch.ones((2, 3), device=cuda)
    w = torch.randn((12, 16), device=cuda)
    refused = [(t["w_a"], t["w_b"]), (w, w.bfloat16()), (w, w[:4, :8].contiguous()),
               (w, torch.randn((16, 12), device=cuda).t())]
    for w_rem, w_quo in refused:
        with pytest.raises(ValueError, match="K3"):
            embedding_bag.qr_embedding_bag_raw(idx, mask, w_rem, w_quo)
        with pytest.raises(ValueError, match="K3"):
            embedding_bag.qr_embedding_bag(idx, idx, mask, w_rem, w_quo)
    for entry in (lambda: embedding_bag.qr_embedding_bag_raw(idx, mask, w, w, op="concat"),
                  lambda: embedding_bag.qr_embedding_bag(idx, idx, mask, w, w, op="concat")):
        with pytest.raises(ValueError, match="mult or add"):
            entry()


def test_qr_ops_route_cuda_tensors_to_the_kernels(cuda):
    """ops.qr_lookup: dense pair → K1 (3-D ids), int8 pair → K5; concat
    and a mixed pair launch nothing.  ops.qr_bag_lookup: dense → K3."""
    rng = np.random.default_rng(4)
    t = _tables(rng, 12, 4, 16, "int8", cuda)
    qa = {"q": t["w_a"], "scale": t["scale_a"], "zp": t["zp_a"]}
    qb = {"q": t["w_b"], "scale": t["scale_b"], "zp": t["zp_b"]}
    wa, wb = (torch.randn((12, 16), device=cuda), torch.randn((4, 16), device=cuda))
    idx = torch.from_numpy(rng.integers(0, 48, size=(2, 3, 5))).to(cuda)
    counters = (qr_gather.qr_gather, qr_gather.qr_gather_quant, embedding_bag.qr_embedding_bag)
    cases = [((wa, wb), {}, (1, 0, 0)), ((qa, qb), {}, (0, 1, 0)),
             ((wa, wb), {"op": "concat"}, (0, 0, 0)), ((qa, wb), {}, (0, 0, 0))]
    for tables, kw, launched in cases:
        before = [c.launches for c in counters]
        got = ops.qr_lookup(idx, *tables, **kw)
        assert tuple(c.launches - n for c, n in zip(counters, before)) == launched
        want = ops.qr_lookup(idx, *tables, use_kernel=False, **kw)
        assert got.shape == want.shape == (2, 3, 5, 32 if kw else 16)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    bag_idx, mask = idx[0], torch.rand((3, 5), device=cuda)
    before = embedding_bag.qr_embedding_bag.launches
    got = ops.qr_bag_lookup(bag_idx, mask, wa, wb)
    assert embedding_bag.qr_embedding_bag.launches == before + 1
    torch.testing.assert_close(got, ops.qr_bag_lookup(bag_idx, mask, wa, wb, use_kernel=False),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_one_hot_scoring_route_on_card(cuda, quant):
    """api(cfg).loss_fn / predict with use_kernel: one grouped K1 launch
    (f32) or one grouped K5 launch (int8), and one K2 per batch; logits and
    loss within 1e-4 of use_kernel=False."""
    sizes = (100, 500, 33, 10_000)
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True), table_sizes=sizes,
                              bottom_mlp=(32, 16), top_mlp=(32,), use_kernel=True)
    kernel_api = dlrm_criteo.api(cfg)
    plain_api = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=False))
    params = kernel_api.init(torch.Generator(device=cuda).manual_seed(0))
    if quant:
        params = quantize_params(params, mode=quant)
    lookup = qr_gather.qr_gather_quant if quant else qr_gather.qr_gather
    shape = Shape("bench", 1, 64, "train")
    for step in (10_000, 10_001):
        batch = kernel_api.batch_fn(step, shape)
        assert batch["sparse"].is_cuda and batch["sparse"].dtype == torch.int32
        k_before, k2_before = lookup.launches, dot_interaction.dot_interaction.launches
        loss, metrics = kernel_api.loss_fn(params, batch)
        torch.cuda.synchronize()
        assert lookup.launches - k_before == 1
        assert dot_interaction.dot_interaction.launches - k2_before == 1
        want_loss, want_metrics = plain_api.loss_fn(params, batch)
        torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
        logits = kernel_api.predict(params, batch)
        assert logits.shape == (64,) and torch.isfinite(logits).all()
        torch.testing.assert_close(logits, plain_api.predict(params, batch), rtol=1e-4,
                                   atol=1e-4)


def _group(rng, sizes, d, mode, cuda, kinds=("qr", "qr", "hash", "full"), proj_to=None):
    """One GroupTable per size, of the kinds in turn (QR pairs with c=4),
    mult and add in turn."""
    tables = []
    for t, size in enumerate(sizes):
        kind = kinds[t % len(kinds)]
        m = -(-size // 4) if kind == "qr" else (max(1, size // 3) if kind == "hash" else 0)
        tt = _tables(rng, m or size, -(-size // max(m, 1)), d, mode, cuda)
        proj = None if proj_to is None else torch.from_numpy(
            rng.normal(size=(d, proj_to)).astype(np.float32)).to(cuda)
        pair = kind == "qr"
        tables.append(ref.GroupTable(tt["w_a"], tt["w_b"] if pair else None, tt.get("scale_a"),
                                     tt.get("zp_a"), tt.get("scale_b") if pair else None,
                                     tt.get("zp_b") if pair else None, m,
                                     ("mult", "add")[t % 2], proj))
    return tables


def _launched_on(counter, fn, *args):
    before = counter.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    return out


def _edge_ids(rng, sizes, b, length, cuda):
    idx = np.stack([rng.integers(0, s, size=(b, length)) for s in sizes], axis=1)
    for t, s in enumerate(sizes):
        m = -(-s // 4)
        for k, v in enumerate((0, m - 1, min(m, s - 1), s - 1)):
            if length:
                idx[k % b, t, k % length] = v
    return torch.from_numpy(idx.astype(np.int32)).to(cuda)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("threads_per_bag", [1, 2, 4, 8, 16])
def test_grouped_serve_pool_matches_plain_and_per_table(cuda, mode, threads_per_bag,
                                                        monkeypatch):
    """Grouped K4 over ragged QR pairs, hash and full tables (D=16 and a
    projected D=24), L in {0, 1, 4, 16}, empty bags, mask None: one launch,
    within tolerance of the plain version and bit-equal to T per-table
    launches of the same kernel on the split ids."""
    monkeypatch.setattr(grouped_lookup, "THREADS_PER_BAG", threads_per_bag)
    sizes = (13, 50, 7, 200, 3, 1_000_003)
    tol = TOL["bf16" if mode == "bf16" else "f32"]
    for length in (0, 1, 4, 16):
        for d, proj_to in ((16, None), (24, 16)):
            rng = np.random.default_rng(length * 10 + d)
            tables = _group(rng, sizes, d, mode, cuda, proj_to=proj_to)
            idx = _edge_ids(rng, sizes, 37, length, cuda)
            mask = torch.from_numpy((rng.random(idx.shape) > 0.3).astype(np.float32)).to(cuda)
            mask[-1] = 0.0                                  # a request of empty bags
            for mk in (mask, None):
                got = _launched_on(serve_path.fused_serve_pool,
                                        serve_path.fused_serve_pool_grouped, idx, mk, tables)
                want = ref.fused_serve_pool_grouped(idx, mk, tables)
                assert got.dtype == want.dtype and got.shape == want.shape
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
                if mk is not None:
                    assert (got[-1] == 0).all()
                for t, tab in enumerate(tables):
                    ia, ib = ref._split_ids(idx[:, t], tab)
                    one = serve_path.fused_serve_pool(
                        ia, torch.ones(ia.shape, device=cuda) if mk is None else mk[:, t],
                        tab.w_a, ib, tab.w_b, tab.scale_a, tab.zp_a, tab.scale_b, tab.zp_b,
                        tab.proj, op=tab.op)
                    assert torch.equal(one, got[:, t])


def _mixed_width_group(rng, sizes, mode, cuda, d_out=16):
    """A memory plan's table set: widths 4, 8 and 16 in turn, kinds QR
    (c=4), full and hash in turn, mult and add in turn; every table
    narrower than ``d_out`` with its ``(d, d_out)`` projection."""
    tables = []
    for t, size in enumerate(sizes):
        d, kind = (4, 8, 16)[t % 3], ("qr", "full", "hash", "qr")[t % 4]
        m = -(-size // 4) if kind == "qr" else (max(1, size // 3) if kind == "hash" else 0)
        tt = _tables(rng, m or size, -(-size // max(m, 1)), d, mode, cuda)
        proj = None if d == d_out else torch.from_numpy(
            (rng.normal(size=(d, d_out)) / d ** 0.5).astype(np.float32)).to(cuda)
        pair = kind == "qr"
        tables.append(ref.GroupTable(tt["w_a"], tt["w_b"] if pair else None, tt.get("scale_a"),
                                     tt.get("zp_a"), tt.get("scale_b") if pair else None,
                                     tt.get("zp_b") if pair else None, m,
                                     ("mult", "add")[t % 2], proj))
    return tables


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("threads_per_bag", [1, 2, 4, 8, 16])
def test_grouped_serve_pool_mixed_widths_with_projections(cuda, mode, threads_per_bag,
                                                          monkeypatch):
    """Grouped K4 over a mixed-width plan's tables: rows of 4, 8 and 16
    elements (int8 rows of 4 and 8 bytes: one- and two-byte loads), a
    projection to D=16 on every narrow table in shared memory, L in {0, 1,
    4, 16}, empty bags: one launch, within tolerance of the plain version
    and bit-equal to per-table launches of the same kernel."""
    monkeypatch.setattr(grouped_lookup, "THREADS_PER_BAG", threads_per_bag)
    sizes = (13, 50, 7, 200, 3, 1_000_003, 26, 10_007, 5, 31, 2, 600)
    for length in (0, 1, 4, 16):
        rng = np.random.default_rng(length + 100)
        tables = _mixed_width_group(rng, sizes, mode, cuda)
        assert {t.w_a.shape[1] for t in tables} == {4, 8, 16}
        idx = _edge_ids(rng, sizes, 37, length, cuda)
        mask = torch.from_numpy((rng.random(idx.shape) > 0.3).astype(np.float32)).to(cuda)
        mask[-1] = 0.0                                      # a request of empty bags
        got = _launched_on(serve_path.fused_serve_pool, serve_path.fused_serve_pool_grouped,
                           idx, mask, tables)
        want = ref.fused_serve_pool_grouped(idx, mask, tables)
        assert got.dtype == want.dtype == torch.float32 and got.shape == (37, len(sizes), 16)
        torch.testing.assert_close(got, want, rtol=TOL["f32"], atol=TOL["f32"])
        assert (got[-1] == 0).all()
        for t, tab in enumerate(tables):
            ia, ib = ref._split_ids(idx[:, t], tab)
            one = serve_path.fused_serve_pool(ia, mask[:, t], tab.w_a, ib, tab.w_b, tab.scale_a,
                                              tab.zp_a, tab.scale_b, tab.zp_b, tab.proj,
                                              op=tab.op)
            assert torch.equal(one, got[:, t])


def _mixed_plan_cfg(sizes, use_kernel=True):
    from repro_torch.plan import build_plan, dim_ladder, full_table_bytes, power_law_stats

    stats = [power_law_stats(n, alpha=1.2) for n in sizes]
    plan = build_plan(stats, 16, int(full_table_bytes(sizes, 16) * 0.25), dims=dim_ladder(16))
    assert len(set(plan.table_dims)) >= 2
    return DLRMConfig(table_sizes=sizes, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,),
                      embedding=plan, use_kernel=use_kernel)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("one_hot", [True, False])
def test_planned_dlrm_forward_kernel_route_matches_plain(cuda, quant, one_hot):
    """A mixed-width planned DLRM on the card: multi-hot ids take one
    grouped K4 with the narrow tables' projections, one-hot ids the
    per-table route (K1 / K5 for each QR pair); logits within 1e-4 of
    use_kernel=False."""
    sizes = (100, 500, 33, 2000)
    cfg = _mixed_plan_cfg(sizes)
    params = dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    assert "proj" in params
    if quant:
        params = quantize_params(params, mode=quant)
    rng = np.random.default_rng(2)
    dense = torch.from_numpy(rng.normal(size=(97, 13)).astype(np.float32)).to(cuda)
    idx = _edge_ids(rng, sizes, 97, 1 if one_hot else 4, cuda)
    idx, mask = (idx[:, :, 0], None) if one_hot else (idx, (torch.rand(idx.shape, device=cuda)
                                                           > 0.3).float())
    k4 = serve_path.fused_serve_pool.launches
    got = dlrm_forward(params, dense, idx, cfg, mask=mask)
    torch.cuda.synchronize()
    assert serve_path.fused_serve_pool.launches == k4 + (0 if one_hot else 1)
    want = dlrm_forward(params, dense, idx, dataclasses.replace(cfg, use_kernel=False), mask=mask)
    assert got.shape == (97,) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_planned_engine_on_card_cache_matches_cache_off(cuda):
    """The mixed-width planned model served int8 on the card: the device
    cache keeps one slab per width and takes the per-feature slab branch;
    its scores equal cache off within 1e-4, and cache off equals the plain
    engine within 1e-4."""
    sizes = (100, 500, 33, 2000)
    cfg = _mixed_plan_cfg(sizes)
    qp = quantize_params(dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda))
    rng = np.random.default_rng(5)
    reqs = [(rng.normal(size=13), [list(rng.integers(0, s, int(rng.integers(0, 5))))
                                   for s in sizes]) for _ in range(96)]
    cache = DeviceHotRowCache(4096, record_events=True)
    on, m = _cache_engine_scores(cfg, qp, reqs, cache)
    off, _ = _cache_engine_scores(cfg, qp, reqs, None)
    plain, _ = _cache_engine_scores(dataclasses.replace(cfg, use_kernel=False), qp, reqs, None)
    assert sorted(cache._slabs) == sorted(set(cfg.embedding.table_dims))
    assert m["cache_paths"]["exact"] > 0
    np.testing.assert_allclose(on, off, rtol=0, atol=1e-4)
    np.testing.assert_allclose(off, plain, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [16, 24])
def test_grouped_qr_gather_quant_matches_plain_and_per_table(cuda, d):
    sizes = (13, 50, 7, 200, 3, 1_000_003)
    rng = np.random.default_rng(d)
    tables = _group(rng, sizes, d, "int8", cuda, kinds=("qr",))
    idx = _edge_ids(rng, sizes, 300, 1, cuda)[:, :, 0]
    got = _launched_on(qr_gather.qr_gather_quant, qr_gather.qr_gather_quant_grouped,
                            idx, tables)
    want = ref.qr_gather_quant_grouped(idx, tables)
    assert got.dtype == torch.float32 and got.shape == want.shape == (300, len(sizes), d)
    torch.testing.assert_close(got, want, rtol=TOL["int8"], atol=TOL["int8"])
    for t, tab in enumerate(tables):
        one = qr_gather.qr_gather_quant(idx[:, t] % tab.m, idx[:, t] // tab.m, tab.w_a, tab.w_b,
                                        tab.scale_a, tab.zp_a, tab.scale_b, tab.zp_b, op=tab.op)
        assert torch.equal(one, got[:, t])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("threads_per_bag", [1, 2, 4, 8, 16])
def test_grouped_qr_gather_matches_plain_and_per_table(cuda, mode, threads_per_bag,
                                                      monkeypatch):
    """Grouped K1 over ragged dense QR pairs (mult and add in turn, D=16
    and 24), the edge ids of every table: one launch, within tolerance of
    the plain version, in the table dtype, and bit-equal to T per-table
    launches on the split ids."""
    monkeypatch.setattr(grouped_lookup, "THREADS_PER_BAG", threads_per_bag)
    sizes = (13, 50, 7, 200, 3, 1_000_003)
    for d in (16, 24):
        rng = np.random.default_rng(d + len(mode))
        tables = _group(rng, sizes, d, mode, cuda, kinds=("qr",))
        idx = _edge_ids(rng, sizes, 300, 1, cuda)[:, :, 0]
        got = _launched_on(qr_gather.qr_gather, qr_gather.qr_gather_grouped, idx, tables)
        want = ref.qr_gather_grouped(idx, tables)
        assert got.dtype == tables[0].w_a.dtype and got.shape == want.shape == (300, 6, d)
        tol = TOL[mode]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        for t, tab in enumerate(tables):
            one = qr_gather.qr_gather(idx[:, t] % tab.m, idx[:, t] // tab.m, tab.w_a, tab.w_b,
                                      op=tab.op)
            assert torch.equal(one, got[:, t])


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("one_hot", [True, False])
def test_dlrm_forward_kernel_route_matches_plain(cuda, quant, one_hot):
    """dlrm_forward with use_kernel (grouped lookup, then K2 writing the
    top MLP's input) against use_kernel=False: logits within 1e-4."""
    sizes = (100, 500, 33, 10_000)
    cfg = DLRMConfig(table_sizes=sizes, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,),
                     embedding=EmbeddingSpec(kind="qr", num_collisions=4), use_kernel=True)
    params = dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    if quant:
        params = quantize_params(params, mode=quant)
    rng = np.random.default_rng(1)
    dense = torch.from_numpy(rng.normal(size=(97, 13)).astype(np.float32)).to(cuda)
    idx = _edge_ids(rng, sizes, 97, 1 if one_hot else 4, cuda)
    idx, mask = (idx[:, :, 0], None) if one_hot else (idx, (torch.rand(idx.shape, device=cuda)
                                                           > 0.3).float())
    k2 = dot_interaction.dot_interaction.launches
    got = dlrm_forward(params, dense, idx, cfg, mask=mask)
    torch.cuda.synchronize()
    assert dot_interaction.dot_interaction.launches == k2 + 1
    want = dlrm_forward(params, dense, idx, dataclasses.replace(cfg, use_kernel=False), mask=mask)
    assert got.shape == (97,) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_grouped_wrapper_refuses_over_the_cap_on_the_card(cuda):
    w = torch.randn((8, 16), device=cuda)
    n = grouped_lookup.MAX_TABLES + 1
    with pytest.raises(ValueError, match="tables"):
        serve_path.fused_serve_pool_grouped(torch.zeros((2, n, 1), dtype=torch.int32,
                                                        device=cuda), None,
                                            [ref.GroupTable(w)] * n)
    with pytest.raises(ValueError, match="differ"):
        serve_path.fused_serve_pool_grouped(
            torch.zeros((2, 2, 1), dtype=torch.int32, device=cuda), None,
            [ref.GroupTable(w), ref.GroupTable(w.bfloat16())])


# ------------------------------------------- over the cap, grad mode, training


@pytest.mark.parametrize("one_hot", [True, False])
def test_grouped_entries_split_more_tables_than_one_launch_takes_on_the_card(cuda, one_hot):
    """41 QR pairs through ops' grouped entries: two launches (40 + 1
    tables), the same values as the per-table route, f32 and int8."""
    rng = np.random.default_rng(12)
    n = grouped_lookup.MAX_TABLES + 1
    sizes = [int(s) for s in rng.integers(5, 3000, size=n)]
    idx = _edge_ids(rng, sizes, 33, 1 if one_hot else 3, cuda)
    mask = (torch.rand(idx.shape, device=cuda) > 0.3).float()
    for mode in ("f32", "int8"):
        pairs = []
        for size in sizes:
            t = _tables(rng, -(-size // 4), 4, 16, mode, cuda)
            if mode == "int8":
                pairs.append(({"q": t["w_a"], "scale": t["scale_a"], "zp": t["zp_a"]},
                              {"q": t["w_b"], "scale": t["scale_b"], "zp": t["zp_b"]}))
            else:
                pairs.append((t["w_a"], t["w_b"]))
        specs = [(a, b, 0, "mult", None) for a, b in pairs]
        counter = (qr_gather.qr_gather_quant if mode == "int8" else qr_gather.qr_gather) \
            if one_hot else serve_path.fused_serve_pool
        before = counter.launches
        if one_hot:
            got = ops.qr_lookup_grouped(idx[:, :, 0], specs)
            want = torch.stack([ops.qr_lookup(idx[:, t, 0], a, b, use_kernel=False)
                                for t, (a, b) in enumerate(pairs)], dim=1)
        else:
            got = ops.serve_bag_pool_grouped(idx, mask, specs)
            want = torch.stack([ops.serve_bag_pool(idx[:, t], mask[:, t], a, b,
                                                   use_kernel=False)
                                for t, (a, b) in enumerate(pairs)], dim=1)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert got.shape == (33, n, 16)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _grad_cases(cuda):
    """(wrapper, call) for every CUDA wrapper, each with a table, mask or
    interaction operand that requires grad."""
    rng = np.random.default_rng(13)
    w = torch.randn((12, 16), device=cuda, requires_grad=True)
    wq = torch.randn((4, 16), device=cuda)
    t = _tables(rng, 12, 4, 16, "int8", cuda)
    scale = t["scale_a"].clone().requires_grad_(True)
    rem = torch.zeros((5,), dtype=torch.int32, device=cuda)
    ids, mask = torch.zeros((5, 3), dtype=torch.int32, device=cuda), torch.ones((5, 3),
                                                                             device=cuda)
    z = torch.randn((5, 16), device=cuda, requires_grad=True)
    feats = torch.randn((5, 3, 16), device=cuda)
    quant = (t["w_a"], t["w_b"], scale, t["zp_a"], t["scale_b"], t["zp_b"])
    return {
        "fused_serve_pool": lambda: serve_path.fused_serve_pool(ids, mask, w, ids, wq),
        "fused_serve_pool_grouped": lambda: serve_path.fused_serve_pool_grouped(
            ids[:, None], mask[:, None].clone().requires_grad_(True),
            [ref.GroupTable(w.detach())]),
        "qr_gather": lambda: qr_gather.qr_gather(rem, rem, w, wq),
        "qr_gather_grouped": lambda: qr_gather.qr_gather_grouped(
            ids[:, :1], [ref.GroupTable(w, wq, m=12)]),
        "qr_gather_quant": lambda: qr_gather.qr_gather_quant(rem, rem, *quant),
        "qr_gather_quant_grouped": lambda: qr_gather.qr_gather_quant_grouped(
            ids[:, :1], [ref.GroupTable(*quant, m=12)]),
        "qr_embedding_bag": lambda: embedding_bag.qr_embedding_bag(ids, ids, mask, w, wq),
        "qr_embedding_bag_raw": lambda: embedding_bag.qr_embedding_bag_raw(ids, mask, w, wq),
        "dot_interaction": lambda: dot_interaction.dot_interaction(
            torch.cat([z[:, None], feats], dim=1)),
        "dot_interaction_concat": lambda: dot_interaction.dot_interaction_concat(z, feats),
    }


@pytest.mark.parametrize("wrapper", [
    "fused_serve_pool", "fused_serve_pool_grouped", "qr_gather", "qr_gather_grouped",
    "qr_gather_quant", "qr_gather_quant_grouped", "qr_embedding_bag", "qr_embedding_bag_raw",
    "dot_interaction", "dot_interaction_concat"])
def test_cuda_wrapper_raises_under_grad(cuda, wrapper):
    """The kernels have no backward: with grad mode on and an operand that
    requires grad, each CUDA wrapper raises instead of returning an output
    with no graph; under torch.no_grad() the same call launches."""
    call = _grad_cases(cuda)[wrapper]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


def _small_train(cuda, device):
    sizes = (100, 500, 33, 10_000)
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True), table_sizes=sizes,
                              bottom_mlp=(32, 16), top_mlp=(32,))
    return cfg, dlrm_criteo.api(cfg, device=device)


def test_training_through_the_kernels_raises_and_the_plain_path_trains(cuda):
    """value_and_grad through use_kernel=True raises on the card (K1's
    launch sees tables that require grad); through the plain path the card's
    loss and gradients equal the CPU's on the same parameters and batch
    (f32 1e-5 relative to each leaf's largest gradient)."""
    from repro_torch import tree
    from repro_torch.train.loop import value_and_grad

    cfg, cpu_api = _small_train(cuda, "cpu")
    params = cpu_api.init(torch.Generator().manual_seed(0))
    batch = cpu_api.batch_fn(3, Shape("t", 1, 64, "train"))
    on_card = tree.tree_map(lambda x: x.to(cuda), params)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    kcfg = dataclasses.replace(cfg, use_kernel=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        value_and_grad(dlrm_criteo.api(kcfg).loss_fn)(on_card, card_batch)
    (loss, _), grads = value_and_grad(cpu_api.loss_fn)(params, batch)
    (card_loss, _), card_grads = value_and_grad(dlrm_criteo.api(cfg).loss_fn)(on_card,
                                                                             card_batch)
    torch.testing.assert_close(card_loss.cpu(), loss, rtol=1e-5, atol=1e-6)
    for g, cg in zip(tree.leaves(grads), tree.leaves(card_grads)):
        scale = max(1.0, float(g.abs().max()))
        torch.testing.assert_close(cg.cpu(), g, rtol=0, atol=1e-5 * scale)


def test_restart_replays_bit_for_bit_with_deterministic_algorithms(cuda, tmp_path):
    """A killed and resumed Trainer on the card ends with the same bits as
    an uninterrupted run, with torch.use_deterministic_algorithms(True)
    (the gathers' backward accumulates with atomics otherwise).  cuBLAS
    needs CUBLAS_WORKSPACE_CONFIG set before its first call (this module
    sets it when imported, unless the caller set another value: then the
    test skips)."""
    from repro_torch import tree
    from repro_torch.train.loop import (SimulatedFailure, TrainConfig, Trainer, init_state,
                                        make_train_step)

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
        pytest.skip("needs CUBLAS_WORKSPACE_CONFIG=:4096:8 (or :16:8) before cuBLAS starts")
    _, api = _small_train(cuda, cuda)
    shape = Shape("t", 1, 64, "train")
    kept = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        state0 = init_state(api.init(torch.Generator(device=cuda).manual_seed(1)),
                            api.optimizer)
        tc = TrainConfig(num_steps=12, ckpt_every=6, ckpt_dir=str(tmp_path), log_every=3)
        step = make_train_step(api.loss_fn, api.optimizer)
        tr = Trainer(step, tc, batch_at=lambda s: api.batch_fn(s, shape))
        with pytest.raises(SimulatedFailure):
            tr.run(state0, fail_at_step=9)
        tr.checkpointer.wait()
        tr2 = Trainer(step, tc, batch_at=lambda s: api.batch_fn(s, shape))
        resumed = tr2.resume_or(state0)
        assert int(resumed["step"]) == 6 and resumed["params"]["top"][0]["w"].is_cuda
        final_resumed, _ = tr2.run(resumed)
        final_direct, _ = Trainer(step, TrainConfig(num_steps=12),
                                  batch_at=lambda s: api.batch_fn(s, shape)).run(state0)
        for a, b in zip(tree.leaves(final_resumed), tree.leaves(final_direct)):
            assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(kept)


@pytest.mark.parametrize("kw, k1_per_batch", [(dict(embedding="qr"), 1),
                                              (dict(embedding="qr", op="add",
                                                    num_collisions=60), 1),
                                              (dict(embedding="qr", threshold=200), 6)])
def test_paper_tables_row_scores_through_the_kernels_on_the_card(cuda, kw, k1_per_batch):
    """``paper_tables.run_row`` on the card at a few steps: finite losses,
    kernel-route scoring equal to plain with one K2 per held-out batch and
    one grouped K1 per batch (every table a QR pair) or one per QR pair
    and batch (a threshold of 200 keeps 4 of the 10 tables full)."""
    from repro_torch.benchmarks import paper_tables as pt

    r = pt.run_row(dlrm_criteo, steps=3, device=cuda, **kw)
    assert len(r.train_losses) == 3 and all(np.isfinite(r.train_losses))
    k = r.kernel
    assert k["launches"] == {"qr_gather": 12 * k1_per_batch, "dot_interaction": 12}
    assert k["launches"] == pt.expected_launches(dlrm_criteo.config(reduced=True, **kw), 12)
    assert k["abs_dbce"] <= pt.SCORE_TOL and k["max_abs_dlogit"] <= pt.SCORE_TOL


def test_paper_tables_train_eval_on_the_card_follows_the_cpu(cuda):
    """``_train_eval`` on the card returns the reference's tuple, and the
    card's first steps follow the CPU's on the same CPU-drawn stream."""
    from repro_torch.benchmarks import paper_tables as pt
    from repro_torch.configs import dcn_criteo

    loss, acc, n, us = pt._train_eval(dcn_criteo, embedding="hash", steps=3, device=cuda)
    assert np.isfinite(loss) and 0 <= acc <= 1 and n > 0 and us > 0
    _, api, params = pt.setup(dlrm_criteo, embedding="qr")

    def batch_at(s):
        return api.batch_fn(s, pt.SHAPE)

    card = pt.train(api.loss_fn, api.optimizer, params, batch_at, 3, cuda)
    cpu = pt.train(api.loss_fn, api.optimizer, params, batch_at, 3, "cpu")
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-5)


def test_kernel_bench_on_the_card(cuda):
    from repro_torch.benchmarks import kernels_bench

    rows = kernels_bench.rows(device=cuda)
    assert [r[0] for r in rows] == [f"kernel/{k}/{v}" for k in ("qr_gather", "qr_bag",
                                                               "dot_interact")
                                    for v in ("ref_torch", "cuda")]
    for name, us, derived in rows:
        assert us > 0
        if name.endswith("/cuda"):
            assert float(derived.split("max_abs_err=")[1]) <= 1e-4


def test_examples_run_on_the_card(cuda, tmp_path, capsys):
    from repro_torch.examples import quickstart, train_dlrm_criteo

    quickstart.main(["--device", "cpu"])
    cpu = capsys.readouterr().out.splitlines()
    quickstart.main(["--device", "cuda"])
    card = capsys.readouterr().out.splitlines()
    assert card[:3] == cpu[:3] and card[-1] == "quickstart OK"
    assert abs(float(card[3].split("loss=")[1].split()[0])
               - float(cpu[3].split("loss=")[1].split()[0])) <= 2e-4
    argv = ["--device", "cuda", "--batch", "32", "--collisions", "60",
            "--ckpt-dir", str(tmp_path)]
    train_dlrm_criteo.main(argv + ["--steps", "3"])
    capsys.readouterr()
    train_dlrm_criteo.main(argv + ["--steps", "5"])
    assert capsys.readouterr().out.splitlines()[1] == "resumed from step 3"


# ------------------------------------------------ observability and online


def _online_requests(rng, sizes, n, spread=False):
    return [(rng.normal(size=13),
             [list(np.floor(rng.random(3) ** (0.7 if spread else 3.0) * s).astype(int)
                   + (s // 2 if spread else 0)) for s in sizes]) for _ in range(n)]


def _wrap_ids(reqs, sizes):
    return [(d, [[int(i) % s for i in bag] for bag, s in zip(bags, sizes)]) for d, bags in reqs]


def _served(engine, reqs):
    uids = [engine.submit(d, b) for d, b in reqs]
    done = engine.run_until_drained()
    return np.array([done[u].score for u in uids])


@pytest.mark.parametrize("batching", ["continuous", "waves"])
def test_obs_is_read_only_on_the_card(cuda, batching):
    """The planned model served int8 with the kernels on, obs off and on
    (trace, collisions, profiler ranges): scores equal bit for bit, one
    grouped K4 and one K2 per wave either way, the partition ratio 1."""
    from repro_torch.obs import Obs

    sizes = (100, 500, 33, 2000)
    cfg = _mixed_plan_cfg(sizes)
    qp = quantize_params(dlrm_init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda))
    reqs = _wrap_ids(_online_requests(np.random.default_rng(1), sizes, 200), sizes)
    out = {}
    for name, obs in (("off", None), ("on", Obs(trace=True, collisions=True,
                                                profiler_annotations=True))):
        eng = RecsysEngine(cfg, qp, max_batch=32, batching=batching, obs=obs)
        k4, k2 = serve_path.fused_serve_pool.launches, dot_interaction.dot_interaction.launches
        scores = _served(eng, reqs)
        waves = eng.metrics()["waves"]
        assert serve_path.fused_serve_pool.launches - k4 == waves
        assert dot_interaction.dot_interaction.launches - k2 == waves
        out[name] = scores, waves, eng
    np.testing.assert_array_equal(out["on"][0], out["off"][0])
    assert out["on"][1] == out["off"][1]
    ss = out["on"][2].stage_summary()
    assert ss["partition"]["ratio"] == pytest.approx(1.0, abs=1e-9)
    assert all(ss[s]["count"] == out["on"][1] for s in ("probe", "dense", "flush"))


def test_migration_on_the_card_equals_the_cpu(cuda):
    """``migrate_params`` of int8 planned params on the card equals the same
    call on CPU copies: f32 within 1e-5 of each leaf's largest |value|, the
    report equal."""
    from repro_torch import tree
    from repro_torch.online import migrate_params
    from repro_torch.plan import build_plan, full_table_bytes, power_law_stats
    from repro_torch.serve.recsys import _to_device

    sizes = (100, 500, 33, 2000)
    old_cfg = _mixed_plan_cfg(sizes)
    stats = [power_law_stats(n, alpha=0.8) for n in sizes]
    new_cfg = dataclasses.replace(old_cfg, embedding=build_plan(
        stats, 16, int(full_table_bytes(sizes, 16) * 0.125), dims=(4, 8, 16)))
    old = quantize_params(dlrm_init(old_cfg, torch.Generator().manual_seed(0), "cpu"))
    fresh = dlrm_init(new_cfg, torch.Generator().manual_seed(1), "cpu")
    got, grep = migrate_params(old_cfg, _to_device(old, cuda), new_cfg, _to_device(fresh, cuda))
    want, wrep = migrate_params(old_cfg, old, new_cfg, fresh)
    assert grep == wrep and grep["counts"].get("folded")
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)


def test_controller_swap_keeps_one_k4_and_one_k2_per_wave_on_the_card(cuda):
    """A forced re-plan through the controller on the card: after the swap
    the engine's waves launch K2 once per dense stage and K4 on every wave
    the tables served; a fresh cache-off engine on the same migrated int8
    params serves one grouped K4 and one K2 per wave, with scores within
    1e-4 of the swapped engine's."""
    from repro_torch.obs import Obs
    from repro_torch.online import ReplanController
    from repro_torch.plan import full_table_bytes

    sizes = (100, 500, 33, 2000)
    cfg = dataclasses.replace(_mixed_plan_cfg(sizes), name="dlrm-criteo")
    qp = quantize_params(dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    eng = RecsysEngine(cfg, qp, max_batch=32, batching="waves", obs=Obs(collisions=True),
                       cache=DeviceHotRowCache(1 << 12))
    rng = np.random.default_rng(3)
    _served(eng, _wrap_ids(_online_requests(rng, sizes, 96), sizes))
    ctrl = ReplanController(eng, budget_bytes=int(full_table_bytes(sizes, 16) * 0.125),
                            dims=(4, 8, 16), quantize="int8")
    assert ctrl.check() is None                      # the bootstrap window
    _served(eng, _wrap_ids(_online_requests(rng, sizes, 96, spread=True), sizes))
    rep = ctrl.replan()
    assert rep["plan"]["total_bytes"] <= rep["plan"]["budget_bytes"]
    assert eng.params["tables"][0] is not qp["tables"][0]
    reqs = _wrap_ids(_online_requests(rng, sizes, 160, spread=True), sizes)
    eng.reset_metrics()
    k4, k2 = serve_path.fused_serve_pool.launches, dot_interaction.dot_interaction.launches
    swapped = _served(eng, reqs)
    m = eng.metrics()
    assert serve_path.fused_serve_pool.launches - k4 == m["cache_paths"]["ingraph"]
    assert dot_interaction.dot_interaction.launches - k2 == \
        m["waves"] + m["cache_paths"]["probe_missed"]
    fresh = RecsysEngine(eng.cfg, eng.params, max_batch=32, batching="waves")
    k4, k2 = serve_path.fused_serve_pool.launches, dot_interaction.dot_interaction.launches
    np.testing.assert_allclose(_served(fresh, reqs), swapped, rtol=0, atol=1e-4)
    waves = fresh.metrics()["waves"]
    assert serve_path.fused_serve_pool.launches - k4 == waves
    assert dot_interaction.dot_interaction.launches - k2 == waves


def test_mixed_radix_tables_keep_one_grouped_k4_per_wave(cuda):
    """Mixed-radix tables (which a re-solved plan may hold) pool beside one
    grouped K4 over the other tables: one K4 and one K2 per wave, scores
    within 1e-4 of the plain engine."""
    sizes = (1000, 500, 33, 2000)
    cfg = DLRMConfig(table_sizes=sizes, emb_dim=16, bottom_mlp=(32, 16), top_mlp=(32,),
                     embedding=EmbeddingSpec(kind="mixed_radix", threshold=100),
                     use_kernel=True)
    qp = quantize_params(dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    reqs = _wrap_ids(_online_requests(np.random.default_rng(4), sizes, 100), sizes)
    eng = RecsysEngine(cfg, qp, max_batch=32, batching="waves")
    k4, k2 = serve_path.fused_serve_pool.launches, dot_interaction.dot_interaction.launches
    got = _served(eng, reqs)
    waves = eng.metrics()["waves"]
    assert serve_path.fused_serve_pool.launches - k4 == waves
    assert dot_interaction.dot_interaction.launches - k2 == waves
    plain = RecsysEngine(dataclasses.replace(cfg, use_kernel=False), qp, max_batch=32,
                         batching="waves")
    np.testing.assert_allclose(got, _served(plain, reqs), rtol=0, atol=1e-4)


# ------------------------------------------------- dist: the data-parallel step


def _dp_setup(device, batch=64):
    """The reduced DLRM-Criteo's api on ``device``, its parameters drawn on
    the CPU and moved, and a CPU-drawn batch function."""
    from repro_torch import tree
    cfg = dlrm_criteo.config(reduced=True)
    host, api = dlrm_criteo.api(cfg, device="cpu"), dlrm_criteo.api(cfg, device=device)
    params = tree.tree_map(lambda t: t.to(device), host.init(torch.Generator().manual_seed(0)))
    shape = Shape("t", 1, batch, "train")
    return api, params, lambda s: tree.tree_map(lambda t: t.to(device), host.batch_fn(s, shape))


@pytest.mark.parametrize("mode", ["bf16", "int8", "auto"])
def test_local_compression_on_the_card_equals_the_cpu(cuda, mode):
    """``ef_psum_grads(group=None)`` carried over 5 calls: outputs and
    residuals on the card bit-equal to the CPU's on the same inputs."""
    from repro_torch import tree
    from repro_torch.dist import AUTO, compress
    _, params, _ = _dp_setup("cpu")
    pol = AUTO if mode == "auto" else mode
    gen = torch.Generator().manual_seed(3)
    errs = {d: compress.init_error_state(tree.tree_map(lambda t, d=d: t.to(d), params), pol)
            for d in ("cpu", "cuda")}
    for _ in range(5):
        g = tree.tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-2, params)
        outs = {}
        for d in ("cpu", "cuda"):
            outs[d], errs[d] = compress.ef_psum_grads(tree.tree_map(lambda t, d=d: t.to(d), g),
                                                      errs[d], group=None, mode=pol)
        for a, b in zip(tree.leaves(outs["cpu"]) + tree.leaves(errs["cpu"]),
                        tree.leaves(outs["cuda"]) + tree.leaves(errs["cuda"])):
            assert torch.equal(a, b.cpu())


def test_dp_step_over_nccl_in_a_world_of_one(cuda):
    """A process group of one over NCCL: the "none" DP step equals
    ``make_train_step`` (within 1e-6 of each leaf's largest |value|: the
    index backward's atomics); the int8 step issues its scale maxima and
    the metric means through ``dist.wire``, at 0 bytes by the ring
    formulas."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist import wire, world
    from repro_torch.train.loop import (init_dp_state, init_state, make_dp_train_step,
                                        make_train_step)
    api, params, batch_at = _dp_setup(cuda)
    world.local("nccl")
    try:
        plain, _ = make_train_step(api.loss_fn, api.optimizer)(init_state(params, api.optimizer),
                                                               batch_at(0))
        dp, m = make_dp_train_step(api.loss_fn, api.optimizer, compress="none")(
            init_dp_state(params, api.optimizer, compress="none"), batch_at(0))
        for a, b in zip(tree.leaves(plain["params"]), tree.leaves(dp["params"])):
            assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(a.abs().max()))
        wire.reset()
        st = init_dp_state(params, api.optimizer, compress="int8")
        step = make_dp_train_step(api.loss_fn, api.optimizer, compress="int8")
        for s in range(2):
            st, m = step(st, batch_at(s))
            assert torch.isfinite(m["loss"])
        snap = wire.snapshot()
        n_leaves = len(tree.leaves(params))
        assert snap["per_kind"]["all_reduce"]["calls"] == 2 * (n_leaves + 1)
        assert snap["total_bytes"] == 0.0
    finally:
        dist.destroy_process_group()


def _gloo_two_on_one_card(rank, world_size, out):
    import json as _json

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist import AUTO, accounting, wire
    from repro_torch.train.loop import init_dp_state, make_dp_train_step
    torch.cuda.set_device(0)
    api, params, batch_at = _dp_setup(torch.device("cuda", 0))
    state = init_dp_state(params, api.optimizer, compress="auto")
    step = make_dp_train_step(api.loss_fn, api.optimizer, compress="auto")
    wire.reset()
    for s in range(3):
        state, _ = step(state, batch_at(s))
    flat = torch.cat([p.reshape(-1) for p in tree.leaves(state["params"])])
    every = [torch.empty_like(flat) for _ in range(world_size)]
    dist.all_gather(every, flat)
    if rank == 0:
        with open(out, "w") as f:
            _json.dump({"equal": all(torch.equal(every[0], e) for e in every[1:]),
                        "recorded": wire.snapshot()["total_bytes"],
                        "accounted": 3 * accounting.dp_step_wire_bytes(
                            params, AUTO, world_size, scalar_allreduces=3)["total_bytes"]}, f)


def test_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0, the "auto" policy, 3 steps: the replicas'
    parameters bitwise equal, the recorded bytes the accounted ones."""
    import json as _json

    from repro_torch.dist import world
    out = tmp_path / "two.json"
    world.spawn(_gloo_two_on_one_card, 2, "gloo", str(out))
    res = _json.loads(out.read_text())
    assert res["equal"]
    assert res["recorded"] == pytest.approx(res["accounted"], rel=1e-12)


def test_train_launcher_and_sweep_on_the_card(cuda, tmp_path, capsys):
    from repro_torch.examples import compression_sweep
    from repro_torch.launch import train
    hist = train.main(["--compress-policy", "int8", "--steps", "3", "--batch", "32",
                       "--log-every", "1", "--metrics-out", str(tmp_path / "m.jsonl")])
    assert len(hist) == 3 and all(np.isfinite(x) for _, x in hist)
    assert (tmp_path / "m.jsonl").exists()
    rows = compression_sweep.main(["--steps", "3", "--budgets", "0.25"])
    assert [r["name"] for r in rows] == ["full", "plan/0.25x", "uniform-hash/0.25x"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert "proxy order vs trained order" in capsys.readouterr().out


# ------------------------------------------------- dist: FSDP and sharded serving


def test_fsdp_step_over_nccl_in_a_world_of_one_equals_the_plain_step(cuda):
    """A process group of one over NCCL, deterministic algorithms: 3 "none"
    FSDP steps equal ``make_train_step``'s bit for bit (at n = 1 every leaf
    scatters whole, the reduction is the identity and the gather a copy)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist import world
    from repro_torch.train.loop import (init_fsdp_state, init_state, make_fsdp_train_step,
                                        make_train_step)
    api, params, batch_at = _dp_setup(cuda)
    world.local("nccl")
    torch.use_deterministic_algorithms(True)
    try:
        plain = init_state(params, api.optimizer)
        fsdp = init_fsdp_state(params, api.optimizer, policy="none")
        pstep = make_train_step(api.loss_fn, api.optimizer)
        fstep = make_fsdp_train_step(api.loss_fn, api.optimizer, None, params, policy="none")
        for s in range(3):
            plain, pm = pstep(plain, batch_at(s))
            fsdp, fm = fstep(fsdp, batch_at(s))
            assert torch.equal(pm["loss"], fm["loss"])
        for a, b in zip(tree.leaves(plain["params"]) + tree.leaves(plain["opt"]),
                        tree.leaves(fsdp["params"]) + tree.leaves(fsdp["opt"])):
            assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def _exchange_two_on_one_card(rank, world_size, out):
    import json as _json

    from repro_torch.core.compositional import table_rows
    from repro_torch.dist import accounting, wire
    from repro_torch.dist.serve_placement import exchange_rows
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    table = torch.randn((64, 12), generator=gen)
    qt = quantize_table(table)
    ids = torch.randint(0, 64, (2, 40, 3), generator=gen, dtype=torch.int32)[rank]
    res = {}
    for name, full in (("f32", table), ("int8", qt)):
        full = {k: v.to(dev) for k, v in full.items()} if name == "int8" else full.to(dev)
        mine = ({k: v[rank * 32:(rank + 1) * 32] for k, v in full.items()} if name == "int8"
                else full[rank * 32:(rank + 1) * 32])
        wire.reset()
        got = exchange_rows(mine, ids.to(dev), world_size, 32, leaf_path="x")
        res[name] = {"equal": bool(torch.equal(got, table_rows(full, ids.to(dev)))),
                     "on_card": got.is_cuda, "recorded": wire.snapshot()["total_bytes"],
                     "accounted": accounting.serve_exchange_wire_bytes(
                         120, 12, world_size, quantized=name == "int8")["total_bytes"]}
    if rank == 0:
        with open(out, "w") as f:
            _json.dump(res, f)


def test_exchange_rows_in_a_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0: the exchanged rows bit-equal to a local
    gather, f32 and int8, and the recorded bytes the accounted ones."""
    import json as _json

    from repro_torch.dist import world
    out = tmp_path / "ex.json"
    world.spawn(_exchange_two_on_one_card, 2, "gloo", str(out))
    for name, r in _json.loads(out.read_text()).items():
        assert r["equal"] and r["on_card"], name
        assert r["recorded"] == r["accounted"], name


def _sharded_engine_two_on_one_card(rank, world_size, out):
    import json as _json

    from repro_torch.kernels import launch_counters
    from repro_torch.launch.serve import request_stream
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(dlrm_criteo.config(reduced=True), use_kernel=True)
    params = dlrm_criteo.api(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    qp = quantize_params(params, mode="int8")
    engine = RecsysEngine(cfg, qp, max_batch=64, batching="waves", device="cuda",
                          mesh_devices=world_size)
    reqs = list(request_stream(np.random.default_rng(0), cfg.table_sizes, 13, 256, 4))
    for fn in launch_counters().values():
        fn.launches = 0
    uids = [engine.submit(*r) for r in reqs]
    done = engine.run_until_drained()
    counts = {name: fn.launches for name, fn in launch_counters().items()}
    single = RecsysEngine(cfg, qp, max_batch=32, batching="waves", device="cuda")
    suids = [single.submit(*r) for r in reqs]
    sdone = single.run_until_drained()
    diff = max(abs(done[u].score - sdone[v].score) for u, v in zip(uids, suids))
    if rank == 0:
        with open(out, "w") as f:
            _json.dump({"counts": counts, "waves": engine.metrics()["waves"],
                        "sharded": len(engine.placement.sharded), "diff": diff}, f)


def test_sharded_engine_launches_one_k4_and_one_k2_per_wave_per_rank(cuda, tmp_path):
    """The reduced int8 DLRM-Criteo sharded over two gloo ranks on cuda:0:
    each rank's wave is one grouped K4 over the replicated features and one
    K2; the scores within 1e-4 of a single-device engine."""
    import json as _json

    from repro_torch.dist import world
    out = tmp_path / "eng.json"
    world.spawn(_sharded_engine_two_on_one_card, 2, "gloo", str(out))
    res = _json.loads(out.read_text())
    assert res["sharded"] > 0 and res["waves"] == 4
    assert res["counts"]["fused_serve_pool"] == res["waves"]
    assert res["counts"]["dot_interaction"] == res["waves"]
    assert sum(res["counts"].values()) == 2 * res["waves"]
    assert res["diff"] <= 1e-4


# ------------------------------------------------- the analyzer on the card

def _acc_programs():
    from repro_torch.analysis.programs import kernel_programs
    return kernel_programs()


@pytest.mark.parametrize("prog", _acc_programs(), ids=lambda p: p.name)
def test_acc_audit_on_the_card(cuda, prog):
    """ACC-002 on the card: each program's result within rtol 5e-3 of the
    magnitude of its terms against an f64 oracle (at the L=16, D=128
    accumulation shape too, where it pools or contracts), its kernel
    launched, and a bf16 running sum of the same bag failing the bound."""
    from repro_torch.analysis.acc_audit import RTOL, audit_program
    findings, row = audit_program(prog, cuda)
    assert findings == [], [f.message for f in findings]
    assert row["program_rel_err"] <= RTOL
    if prog.kernel is not None:
        assert row["launches"] >= 1
    if prog.audit is not None:
        assert row["audit_rel_err"] <= RTOL < row["control_rel_err"]


def test_jit_audit_on_the_card(cuda):
    """JIT-002 on a card engine: the canonical stream twice, signatures
    within the pow2-bucket bound, none added by the replay, and one grouped
    K4 and one K2 per wave."""
    from repro_torch.analysis import jit_audit
    from repro_torch.kernels import launch_counters
    engine = jit_audit._build_engine("cuda")
    for fn in launch_counters().values():
        fn.launches = 0
    findings, tel = jit_audit.replay_and_audit(engine)
    counts = {name: fn.launches for name, fn in launch_counters().items()}
    assert findings == [] and tel["replay"] == tel["first_pass"]
    assert tel["first_pass"]["per_program"]["embed"] <= tel["bounds"]["embed"]
    assert counts["fused_serve_pool"] == counts["dot_interaction"] == tel["waves"] > 0


def test_wire_audit_in_a_gloo_world_of_four_on_one_card(cuda):
    """WIRE-001 in a gloo world of 4 on cuda:0: on every rank, the bytes
    intercepted at torch.distributed, dist.wire's record and the closed
    form agree to the byte for all eight exchanges."""
    from repro_torch.analysis.wire_audit import audit_rows, run_world, wire_programs
    per_rank = run_world(4, "cuda")
    findings, rows = audit_rows(per_rank)
    assert findings == [], [f.message for f in findings]
    assert [r["name"] for r in rows] == [name for name, _ in wire_programs()]
    assert all(r["intercepted_bytes"] == r["closed_form_bytes"] > 0 for r in rows)
