"""The port's LM (``repro_torch.models.lm``, ``data.lm``, ``serve.engine``,
``configs.tinyllama_1_1b`` and the launchers) held against the JAX
package on the reduced TinyLlama: JAX-initialised parameters carried
across by ``params_from_jax``, numpy-seeded batches, the JAX results
shared through module-scoped fixtures (each JAX call jitted once).

Tolerances (f32): 1e-5 where the operations match one for one (the
loss, the embedding, a chunked xent on given hidden states); 1e-4 of
each tensor's largest magnitude through the whole stack (hidden states,
logits, caches, gradients and Adam's moments: the flash loop and the
matmuls sum in another order than XLA's).  The K1 route and the plain
lookup are bit-equal (a product or sum of two table values, combined in
f32 and rounded once).  Greedy decoding is held token for token, with
every step's top-2 logit gap above the logit tolerance, so a near-tie
would fail as a tie instead of passing or failing by chance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tinyllama_1_1b as jtiny
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.loop import init_state as jax_init_state
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.configs import tinyllama_1_1b as ttiny
from repro_torch.convert import params_from_jax
from repro_torch.core import EmbeddingSpec as TSpec
from repro_torch.data import lm as tdata
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import init_state, make_train_step, value_and_grad

TOL = 1e-4          # through the whole stack, of each tensor's largest magnitude
B, S = 2, 24        # S does not divide into the reduced config's xent chunk of 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel_close(got, want, tol=TOL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    tokens[0, :2] = (0, cfg.vocab - 1)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


@pytest.fixture(scope="module")
def ref():
    """The reduced TinyLlama in both packages, one batch, and the JAX
    package's results on them (one jitted call each)."""
    jcfg, tcfg = jtiny.config(reduced=True), ttiny.config(reduced=True)
    init = jax.jit(functools.partial(jlm.init, cfg=jcfg))
    jp = init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    api = jtiny.api(jcfg)
    step = jax.jit(jax_make_train_step(api.loss_fn, api.optimizer))
    new_state, metrics = step(jax_init_state(jp, api.optimizer), jb)
    h0 = np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    forward = jax.jit(functools.partial(jlm.forward_hidden, cfg=jcfg))
    hidden = forward(jp, jnp.asarray(h0))[0]

    def serve(p, tokens):
        cache = jlm.make_decode_cache(jcfg, B, S + 8)
        logits, cache = jlm.prefill(p, tokens, cache, jcfg)
        logits2, cache2 = jlm.decode_step(p, tokens[:, -1:], S, cache, jcfg)
        return logits, cache, logits2, cache2

    serve = jax.jit(serve)
    served = serve(jp, jb["tokens"])
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, batch=batch, api=api,
                new_state=jax.tree.map(np.asarray, new_state), loss=float(metrics["loss"]),
                h0=h0, hidden=np.asarray(hidden),
                served=jax.tree.map(np.asarray, served))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------- model


def test_init_tree_matches_the_reference_layout():
    jcfg, tcfg = jtiny.config(reduced=True), ttiny.config(reduced=True)
    for jc, tc, device in ((jcfg, tcfg, "cpu"), (jtiny.config(), ttiny.config(), "meta")):
        want = jax.eval_shape(functools.partial(jlm.init, cfg=jc), jax.random.PRNGKey(0))
        got = tlm.init(torch.Generator().manual_seed(0), tc, device)
        wf = jax.tree_util.tree_flatten_with_path(want)[0]
        gf = tree.flatten_with_path(got)
        assert [tuple(getattr(k, "key", None) for k in p) for p, _ in wf] == [p for p, _ in gf]
        assert [(tuple(a.shape), str(a.dtype)) for _, a in wf] \
            == [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in gf]
        assert gf[0][1].shape[0] != tc.n_layers        # embed first, then stacked layers
        assert all(t.shape[0] == tc.n_layers for p, t in gf if p[0] == "layers")
    # the full config: 1,050,904,576 parameters, 2,101,809,152 bytes in bf16
    full = tlm.init(torch.Generator(), ttiny.config(), "meta")
    assert tlm.num_params(full) == 1_050_904_576
    assert sum(t.numel() * t.element_size() for t in tree.leaves(full)) == 2_101_809_152
    assert tuple(full["embed"]["table_0"].shape) == (8000, 2048)
    assert tuple(full["embed"]["table_1"].shape) == (4, 2048)


def test_loss_gradients_and_an_adam_step_match_the_reference(ref):
    tp, api = ref["tp"], ttiny.api(ref["tcfg"], device="cpu")
    assert type(api.optimizer).__name__ == type(ref["api"].optimizer).__name__
    assert (api.accum, api.accum_dtype) == (ref["api"].accum, ref["api"].accum_dtype) == (
        2, "float32")
    (loss, metrics), grads = value_and_grad(api.loss_fn)(tp, _tb(ref["batch"]))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert float(metrics["aux"]) == 0.0
    # Adam's first moment is (1 - b1)·g: the reference's gradients
    want_m = [m["m"] for m in ref["new_state"]["opt"]]
    for g, m in zip(tree.leaves(grads), want_m):
        _rel_close(g * 0.1, m)
    state, step_metrics = make_train_step(api.loss_fn, api.optimizer)(
        init_state(tp, api.optimizer), _tb(ref["batch"]))
    assert abs(float(step_metrics["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for got, want in zip(state["opt"], ref["new_state"]["opt"]):
        _rel_close(got["m"], want["m"])
        _rel_close(got["v"], want["v"])
    for got, want in zip(tree.leaves(state["params"]), jax.tree.leaves(
            ref["new_state"]["params"])):
        _rel_close(got, want)
    assert int(state["step"]) == 1


def test_forward_hidden_and_remat_match_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    got, aux = tlm.forward_hidden(tp, _t(ref["h0"]), tcfg)
    _rel_close(got, ref["hidden"])
    assert float(aux) == 0.0
    # remat (a checkpoint per layer) changes memory, not values or gradients
    h = _t(ref["h0"]).requires_grad_(True)
    plain = dataclasses.replace(tcfg, remat=False)
    g_remat = torch.autograd.grad(tlm.forward_hidden(tp, h, tcfg)[0].square().sum(), h)[0]
    g_plain = torch.autograd.grad(tlm.forward_hidden(tp, h, plain)[0].square().sum(), h)[0]
    torch.testing.assert_close(g_remat, g_plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_chunked_xent_matches_the_reference(chunk):
    rng = np.random.default_rng(chunk)
    h = rng.normal(size=(B, S, 32)).astype(np.float32)
    w = rng.normal(size=(32, 100)).astype(np.float32)
    labels = rng.integers(0, 100, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    xent = jax.jit(functools.partial(jlm.chunked_xent, chunk=chunk))
    want = float(xent(jnp.asarray(h), jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(w)))
    got = float(tlm.chunked_xent(_t(h), _t(labels), _t(mask), _t(w), chunk))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_prefill_and_decode_step_match_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    logits, cache, logits2, cache2 = ref["served"]
    tokens = _t(ref["batch"]["tokens"])
    with torch.inference_mode():
        c = tlm.make_decode_cache(tcfg, B, S + 8, "cpu")
        got, c = tlm.prefill(tp, tokens, c, tcfg)
        _rel_close(got, logits)
        assert got.dtype == torch.float32 and got.shape == (B, 1, tcfg.vocab)
        for k in ("k", "v"):
            _rel_close(c[k], cache[k])
        got2, c = tlm.decode_step(tp, tokens[:, -1:], S, c, tcfg)
        _rel_close(got2, logits2)
        for k in ("k", "v"):
            _rel_close(c[k], cache2[k])


# ---------------------------------------------------------------- the vocabulary's routes


def _spy(monkeypatch):
    calls = []
    real = tlm.ops.qr_lookup_grouped

    def spy(idx, tables):
        calls.append((tuple(idx.shape), len(tables)))
        return real(idx, tables)

    monkeypatch.setattr(tlm.ops, "qr_lookup_grouped", spy)
    return calls


@pytest.mark.parametrize("op", ["mult", "add"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_route_is_bit_equal_to_the_plain_lookup(monkeypatch, op, dtype):
    # vocab 500 with c=4: m = 125 remainder rows, and 500 is a multiple of
    # 4 but the ids 0, m-1, m and V-1 land on every table edge
    spec = dataclasses.replace(TSpec(kind="qr", num_collisions=4), op=op)
    cfg = dataclasses.replace(ttiny.config(reduced=True), vocab=500, embedding=spec,
                              param_dtype=dtype, compute_dtype=dtype)
    calls = _spy(monkeypatch)
    params = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tuple(params["embed"]["table_0"].shape) == (125, 64)
    tokens = torch.tensor([[0, 124, 125, 499, 250, 3], [7, 126, 498, 1, 0, 499]])
    got = tlm.embed_serving(params, tokens, cfg)
    assert calls == [((12, 1), 1)]                        # one grouped lookup, raw ids
    assert torch.equal(got, tlm.embed_tokens(params, tokens, cfg))
    assert got.dtype == cfg.cdtype and got.shape == (2, 6, 64)
    with torch.inference_mode():
        cache = tlm.make_decode_cache(cfg, 2, 8, "cpu")
        tlm.prefill(params, tokens, cache, cfg)
        tlm.decode_step(params, tokens[:, :1], 6, cache, cfg)
    assert len(calls) == 3                                # once per prefill and per decode step


@pytest.mark.parametrize("kind", ["full", "hash"])
def test_full_and_hash_vocabularies_take_the_plain_route(monkeypatch, kind):
    jcfg = jtiny.config(reduced=True, embedding=kind)
    tcfg = ttiny.config(reduced=True, embedding=kind)
    jparams = {"embed": jlm.embed_module(jcfg).init(jax.random.PRNGKey(1))}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = _batch(jcfg)["tokens"]
    calls = _spy(monkeypatch)
    got = tlm.embed_serving(tparams, _t(tokens), tcfg)
    assert calls == []
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jlm.embed_tokens(jparams, jnp.asarray(tokens), jcfg)))


def test_moe_and_mla_wait_for_18b(capsys):
    # every LM arch of the JAX package is ported now (the encoder-decoder and
    # VLM archs last, ROADMAP item 18b-iii): the registry resolves all twelve
    # of the reference's archs, in its order, each with its own name
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS

    assert list(ARCHS) == list(JARCHS) and len(ARCHS) == 12
    for arch in JARCHS:
        mod = get_arch(arch)
        assert mod.ARCH == arch and mod.config().name == arch
    assert get_arch("tinyllama-1.1b") is ttiny
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b"])
def test_init_fills_the_stack_bit_equal_to_stacking_the_layers(arch):
    # init allocates each stacked leaf once and copies each layer's draws
    # into its slice: the values equal drawing every layer, then stacking
    from repro_torch.nn.layers import dense_init, rmsnorm_init

    cfg = get_arch(arch).config(reduced=True)
    got = tlm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    embed = tlm.embed_module(cfg).init(gen, "cpu")
    per_layer = [tlm._layer_init(gen, cfg, "cpu") for _ in range(cfg.n_layers)]
    layers = tree.unflatten(per_layer[0], [torch.stack(group) for group in zip(
        *(tree.leaves(p) for p in per_layer))])
    want = {"embed": embed, "layers": layers,
            "final_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, "cpu"),
            "lm_head": dense_init(gen, cfg.d_model, cfg.vocab, cfg.pdtype, device="cpu")}
    gf, wf = tree.flatten_with_path(got), tree.flatten_with_path(want)
    assert [p for p, _ in gf] == [p for p, _ in wf]
    for (path, a), (_, b) in zip(gf, wf):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------- data


def test_lm_stream_contract():
    a = tdata.batch_at(0, 7, 8, 64, 100, device="cpu")
    b = tdata.batch_at(0, 7, 8, 64, 100, device="cpu")
    c = tdata.batch_at(0, 8, 8, 64, 100, device="cpu")
    assert a["tokens"].shape == a["labels"].shape == a["mask"].shape == (8, 64)
    assert (a["tokens"].dtype, a["labels"].dtype, a["mask"].dtype) == (
        torch.int32, torch.int32, torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)               # stateless per (seed, step)
    assert not torch.equal(a["tokens"], c["tokens"])             # steps differ
    assert not torch.equal(a["tokens"], tdata.batch_at(1, 7, 8, 64, 100, device="cpu")["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])  # next-token labels
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 100
    # learnable: the planted chain concentrates each token's successors (the
    # bigram entropy is well below the uniform log(vocab))
    big = tdata.batch_at(0, 0, 64, 128, 100, device="cpu")
    prev, nxt = big["tokens"].flatten().long(), big["labels"].flatten().long()
    counts = torch.zeros((100, 100)).index_put_((prev, nxt), torch.ones(prev.numel()),
                                                accumulate=True)
    p = counts / counts.sum(1, keepdim=True).clamp(min=1)
    ent = -(p * torch.log(p.clamp(min=1e-12))).sum(1)
    w = counts.sum(1) / counts.sum()
    assert float((w * ent).sum()) < 0.6 * np.log(100)
    stub = tdata.frames_at(0, 3, 2, 5, 8, device="cpu")
    assert stub.shape == (2, 5, 8) and torch.equal(stub, tdata.frames_at(0, 3, 2, 5, 8,
                                                                         device="cpu"))
    assert tdata.patches_at(0, 3, 2, 4, 8, device="cpu").shape == (2, 4, 8)


# ---------------------------------------------------------------- serving engine


def _queue(engine):
    uids = [engine.submit([1, 2, 3, 4, 5], max_new_tokens=6) for _ in range(5)]
    uids += [engine.submit([9, 8, 7, 6, 5, 4, 3, 2, 1], max_new_tokens=20) for _ in range(3)]
    return uids


def _engines(ref, eos_id=None, record=None):
    jcfg, tcfg, jp, tp = ref["jcfg"], ref["tcfg"], ref["jp"], ref["tp"]
    kw = dict(batch_size=4, max_len=20, eos_id=eos_id)
    je = JaxEngine(prefill_fn=lambda t, c: jlm.prefill(jp, t, c, jcfg),
                   decode_fn=lambda t, pos, c: jlm.decode_step(jp, t, pos, c, jcfg),
                   make_cache_fn=lambda b, ml: jlm.make_decode_cache(jcfg, b, ml), **kw)

    def logged(fn):
        def call(*args):
            logits, cache = fn(*args)
            if record is not None:
                record.append(logits[:, -1].clone())
            return logits, cache
        return call

    te = ServeEngine(prefill_fn=logged(lambda t, c: tlm.prefill(tp, t, c, tcfg)),
                     decode_fn=logged(lambda t, pos, c: tlm.decode_step(tp, t, pos, c, tcfg)),
                     make_cache_fn=lambda b, ml: tlm.make_decode_cache(tcfg, b, ml, "cpu"),
                     device="cpu", **kw)
    return je, te


def test_greedy_engine_matches_the_reference_token_for_token(ref):
    record = []
    je, te = _engines(ref, record=record)
    uids = _queue(je), _queue(te)
    want, got = je.run_until_drained(), te.run_until_drained()
    assert uids[0] == uids[1] and set(got) == set(want) == set(uids[0])
    assert {u: got[u].output for u in got} == {u: want[u].output for u in want}
    # largest bucket first: 4 of the 5-token prompts, the 3 long ones (their
    # budget of 20 stops at max_len, pos 19, after 20 - 9 = 11 tokens), the
    # last short one
    assert [len(got[u].output) for u in uids[1]] == [6] * 5 + [11] * 3
    # the step logits that chose tokens for real rows are never near-ties
    rows = [4] * 6 + [3] * 11 + [1] * 6
    assert len(record) == len(rows)
    for logits, n in zip(record, rows):
        top = torch.topk(logits[:n], 2, dim=-1).values
        assert float((top[:, 0] - top[:, 1]).min()) > TOL * float(logits[:n].abs().max())
    # an EOS stop: the second token one long request emitted ends it there
    first = want[uids[0][5]].output
    eos = first[1]
    je, te = _engines(ref, eos_id=eos)
    _queue(je), _queue(te)
    want, got = je.run_until_drained(), te.run_until_drained()
    assert {u: got[u].output for u in got} == {u: want[u].output for u in want}
    assert got[uids[0][5]].output == first[:first.index(eos) + 1]


def test_temperature_sampling_is_seeded(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]

    def run(seed):
        e = ServeEngine(prefill_fn=lambda t, c: tlm.prefill(tp, t, c, tcfg),
                        decode_fn=lambda t, pos, c: tlm.decode_step(tp, t, pos, c, tcfg),
                        make_cache_fn=lambda b, ml: tlm.make_decode_cache(tcfg, b, ml, "cpu"),
                        batch_size=4, max_len=32, temperature=0.8, seed=seed, device="cpu")
        uids = [e.submit([1, 2, 3], max_new_tokens=8) for _ in range(6)]
        done = e.run_until_drained()
        return [done[u].output for u in uids]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert all(len(o) == 8 and all(0 <= t < tcfg.vocab for t in o) for o in a)


# ---------------------------------------------------------------- entry points


def test_launchers_and_example_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve, train

    done = serve.main(["--device", "cpu", "--arch", "tinyllama-1.1b"])
    assert len(done) == 12 and all(len(r.output) == 12 for r in done.values())
    hist = train.main(["--device", "cpu", "--arch", "tinyllama-1.1b", "--steps", "3",
                       "--batch", "4", "--seq-len", "16", "--log-every", "1"])
    assert [s for s, _ in hist] == [0, 1, 2] and all(np.isfinite(x) for _, x in hist)
    done = serve_lm.main(["--device", "cpu"])
    assert len(done) == 15 and all(len(r.output) == 16 for r in done.values())
    out = capsys.readouterr().out
    assert "tinyllama-1.1b: served 12 requests / 144 tokens" in out
    assert "tinyllama-1.1b: 115,264 parameters (embedding=qr)" in out
    assert "tok/s on the CPU" in out
