"""Training's QR pairs on the CPU: ``QRPairs`` and K6's plain version
(``ref.qr_pairs_backward``, which the wrapper takes for CPU tensors)
against autograd of the per-table route's gathers
(``CompositionalEmbedding.apply``), the embed stage keeping that route on
the CPU, and the wrapper's checks on ``meta`` operands.  K6 itself is held
against the plain version on the card in ``test_torch_gpu.py``.

Tolerances: f32 gradients 1e-6 of each table's largest (the same f32
products, summed in sample order on both sides); bf16 gradients against
autograd of the same gathers on the tables' f32 copies, rounded once: K6
multiplies and sums in f32 and rounds each gradient row once, where bf16
autograd rounds every product and every add.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import qr_embedding
from repro_torch.kernels import _build, ops, qr_pairs_backward
from repro_torch.models import dlrm

CASES = {
    # (categories, collisions, batch, zipf exponent): a 1-row and a 4-row
    # table with every id on them, a skewed pair, an empty batch
    "one-row": (4, 4, 64, 1.0),
    "four-row": (16, 4, 64, 1.0),
    "zipf": (5_000, 4, 256, 4.0),
    "empty": (40, 4, 0, 1.0),
}


def _pair(name, op, dtype, seed):
    size, c, b, skew = CASES[name]
    mod = qr_embedding(size, 8, num_collisions=c, op=op, param_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    params = mod.init(gen, device="cpu")
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(np.minimum(np.floor(size * rng.random(b) ** skew), size - 1)
                           .astype(np.int64))
    return mod, params, ids


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["mult", "add"])
def test_plain_k6_matches_autograd_of_the_gathers(op, dtype, case):
    pairs = [_pair(case, op, dtype, seed) for seed in (0, 1)]
    tables = [p[k].requires_grad_(True) for _, p, _ in pairs for k in ("table_0", "table_1")]
    rem = [mod.partitions[0].bucket(ids) for mod, _, ids in pairs]
    quo = [mod.partitions[1].bucket(ids) for mod, _, ids in pairs]
    outs = ops.qr_pairs(rem, quo, tables, [op, op])
    for out, (mod, params, ids) in zip(outs, pairs):
        assert torch.equal(out, mod.apply(params, ids))      # the forward is today's ops
    gen = torch.Generator().manual_seed(7)
    gs = [torch.randn(out.shape, generator=gen).to(dtype) for out in outs]
    got = torch.autograd.grad(outs, tables, gs)

    wide = [t.detach().float().requires_grad_(True) for t in tables]
    plain = [mod.apply({"table_0": wide[2 * j], "table_1": wide[2 * j + 1]}, ids)
             for j, (mod, _, ids) in enumerate(pairs)]
    want = torch.autograd.grad(plain, wide, [g.float() for g in gs])
    for g, w in zip(got, want):
        assert g.dtype == dtype
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.float(), w.to(dtype).float(), rtol=0, atol=1e-6 * scale)
    base = got[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)   # one flat buffer


def test_double_backward_raises():
    mod, params, ids = _pair("four-row", "mult", torch.float32, 0)
    tables = [params["table_0"].requires_grad_(True), params["table_1"].requires_grad_(True)]
    (out,) = ops.qr_pairs([mod.partitions[0].bucket(ids)], [mod.partitions[1].bucket(ids)],
                          tables, ["mult"])
    grads = torch.autograd.grad(out.square().sum(), tables, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(grads[0].sum(), tables)


def test_embed_stage_keeps_the_per_table_route_on_the_cpu(monkeypatch):
    """DCN and ``use_kernel=False`` DLRM train on the CPU through each
    module's ``apply``: ``ops.qr_pairs`` is never reached, under grad or
    not."""
    from repro_torch.configs import dcn_criteo, dlrm_criteo
    from repro_torch.configs.common import Shape
    from repro_torch.train.loop import value_and_grad

    def refuse(*args, **kw):
        raise AssertionError("a CPU table went through the QR pairs' Function")

    monkeypatch.setattr(dlrm.ops, "qr_pairs", refuse)
    for mod in (dcn_criteo, dlrm_criteo):
        cfg = dataclasses.replace(mod.config(reduced=True), table_sizes=(100, 500, 33))
        assert any(dlrm._qr2(m) for m in dlrm.tables_for(cfg))
        api = mod.api(cfg, device="cpu")
        params = api.init(torch.Generator().manual_seed(0))
        batch = api.batch_fn(0, Shape("t", 1, 32, "train"))
        (loss, _), grads = value_and_grad(api.loss_fn)(params, batch)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree.leaves(grads))


def _bad_calls():
    """Calls of the wrapper on ``meta`` operands that K6 does not take:
    (grads, rem, quo, tables, ops)."""
    m = torch.device("meta")
    w, wq = torch.empty((12, 8), device=m), torch.empty((4, 8), device=m)
    ids = torch.empty((5,), dtype=torch.int64, device=m)
    g = torch.empty((5, 8), device=m)
    return {
        "f16 tables": ([g.half()], [ids], [ids], [w.half(), wq.half()], ["mult"]),
        "mixed dtypes": ([g], [ids], [ids], [w, wq.bfloat16()], ["mult"]),
        "strided table": ([g], [ids], [ids], [torch.empty((8, 12), device=m).t(), wq], ["mult"]),
        "widths": ([g], [ids], [ids], [w, torch.empty((4, 16), device=m)], ["mult"]),
        "float ids": ([g], [ids.float()], [ids], [w, wq], ["mult"]),
        "gradient shape": ([g[:4]], [ids], [ids], [w, wq], ["mult"]),
        "concat": ([g], [ids], [ids], [w, wq], ["concat"]),
        "cap": ([g] * 41, [ids] * 41, [ids] * 41, [w, wq] * 41, ["mult"] * 41),
        "counts": ([g], [ids], [ids], [w], ["mult"]),
        "mixed devices": ([torch.zeros((5, 8))], [ids], [ids], [w, wq], ["mult"]),
    }


@pytest.mark.parametrize("what", list(_bad_calls()))
def test_wrapper_refuses_what_k6_does_not_take(what, monkeypatch):
    def no_build(name):
        raise AssertionError("the checks must refuse before any build")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError):
        qr_pairs_backward.qr_pairs_backward(*_bad_calls()[what])


def test_meta_call_returns_views_and_counts_its_bytes(monkeypatch):
    seen = []
    monkeypatch.setattr(_build, "meta_observers", [lambda name, n: seen.append((name, n))])
    m = torch.device("meta")
    tables = [torch.empty((12, 8), device=m), torch.empty((4, 8), device=m),
              torch.empty((7, 8), device=m), torch.empty((2, 8), device=m)]
    ids = torch.empty((5,), dtype=torch.int64, device=m)
    grads = [torch.empty((5, 8), device=m)] * 2
    before = qr_pairs_backward.qr_pairs_backward.launches
    out = qr_pairs_backward.qr_pairs_backward(grads, [ids] * 2, [ids] * 2, tables,
                                              ["mult", "add"])
    assert [tuple(t.shape) for t in out] == [(12, 8), (4, 8), (7, 8), (2, 8)]
    # g read per side, both ids per side, the gradients written, the other
    # row per entry of the mult pair
    assert seen == [("qr_pairs_backward", 2 * 2 * 5 * 8 * 4 + 2 * 4 * 5 * 8 + 25 * 8 * 4
                     + 2 * 5 * 8 * 4)]
    assert qr_pairs_backward.qr_pairs_backward.launches == before
