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

import numpy as np
import pytest
import torch

from repro_torch.configs import dlrm_criteo
from repro_torch.configs.common import Shape
from repro_torch.core import EmbeddingSpec
from repro_torch.kernels import dot_interaction, embedding_bag, ops, qr_gather, ref, serve_path
from repro_torch.launch import serve as launch_serve
from repro_torch.models.dlrm import DLRMConfig, dlrm_init
from repro_torch.serve.quantize import quantize_params, quantize_table
from repro_torch.serve.recsys import RecsysEngine

TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 3e-2}

pytestmark = pytest.mark.gpu


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
        assert launched == ((len(sizes) * waves, waves) if use_kernel else (0, 0))
    assert np.isfinite(scores[True]).all()
    np.testing.assert_allclose(scores[True], scores[False], rtol=0, atol=1e-4)


def test_launcher_serves_on_card_by_default(cuda, capsys):
    done = launch_serve.main(["--requests", "16", "--batch-size", "8"])
    assert len(done) == 16 and all(np.isfinite(r.score) for r in done.values())
    assert "served 16 requests" in capsys.readouterr().out


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
    rng = np.random.default_rng(10)
    m, q = 64, 8
    # positive rows: no cancellation, so a bf16 running sum's error compounds
    wr = torch.from_numpy(np.abs(rng.normal(size=(m, 128))) + 0.5).to(cuda, torch.bfloat16)
    wq = torch.from_numpy(np.abs(rng.normal(size=(q, 128))) + 0.5).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, m * q, size=(8, 16))).to(cuda)
    mask = torch.ones((8, 16), device=cuda)
    got = ops.qr_bag_lookup(idx, mask, wr, wq, op=op)
    a, b = wr.float()[idx % m], wq.float()[idx // m]
    want = (a * b if op == "mult" else a + b).sum(dim=1)
    torch.testing.assert_close(got.float(), want, rtol=5e-3, atol=0)


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
    """api(cfg).loss_fn / predict with use_kernel: one K1 (f32) or K5
    (int8) launch per table and one K2 per batch; logits and loss within
    1e-4 of use_kernel=False."""
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
        assert lookup.launches - k_before == len(sizes)
        assert dot_interaction.dot_interaction.launches - k2_before == 1
        want_loss, want_metrics = plain_api.loss_fn(params, batch)
        torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
        logits = kernel_api.predict(params, batch)
        assert logits.shape == (64,) and torch.isfinite(logits).all()
        torch.testing.assert_close(logits, plain_api.predict(params, batch), rtol=1e-4,
                                   atol=1e-4)
