"""The port's SSM family (``repro_torch.models.hybrid``,
``configs.{mamba2_370m, zamba2_1_2b}``) held against the JAX package on
the reduced configs: JAX-initialised parameters carried across by
``params_from_jax``, numpy-seeded batches, the JAX results shared through
module-scoped fixtures (all of them from one compile per arch).

Tolerances (f32) as ``tests/test_torch_lm_moe.py``: 1e-5 on the loss,
1e-4 of each tensor's largest magnitude through the whole stack (logits,
caches, gradients, the Adam step).  The full configs' parameter counts
and bytes are held to ``jax.eval_shape`` of the reference's ``init`` on
the meta device.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import hybrid as jhy
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.loop import init_state as jax_init_state
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import hybrid as thy
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import init_state, make_train_step, value_and_grad

TOL = 1e-4
B, S = 2, 24
ARCHS = ("mamba2-370m", "zamba2-1.2b")


def _fns(arch, pkg):
    """(init, loss_fn, make_cache, prefill, decode_step) of an arch's family."""
    kind = "mamba" if arch == "mamba2-370m" else "hybrid"
    return tuple(getattr(pkg, f"{kind}_{n}") for n in ("init", "loss_fn", "make_cache",
                                                       "prefill", "decode_step"))


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


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One reduced arch in both packages, one batch, and the JAX package's
    results on them: loss and gradients, one Adam step, prefill and two
    decode steps."""
    arch = request.param
    jmod, tmod = JARCHS[arch], get_arch(arch)
    jcfg, tcfg = jmod.config(reduced=True), tmod.config(reduced=True)
    jinit, jloss, jcache, jprefill, jdecode = _fns(arch, jhy)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    api = jmod.api(jcfg)

    def reference(key, jb):
        jp = jinit(key, jcfg)
        (loss, _), grads = jax.value_and_grad(lambda p, b: jloss(p, b, jcfg), has_aux=True)(
            jp, jb)
        # the reference's train step (accum 1, no clipping) is these
        # gradients through its optimizer's update
        state0 = jax_init_state(jp, api.optimizer)
        new_params, new_opt = api.optimizer.update(grads, state0["opt"], jp, state0["step"])
        tokens = jb["tokens"]
        cache = jcache(jcfg, B, S + 8)
        logits, cache = jprefill(jp, tokens, cache, jcfg)
        logits2, cache2 = jdecode(jp, tokens[:, -1:], S, cache, jcfg)
        logits3, cache3 = jdecode(jp, tokens[:, -2:-1], S + 1, cache2, jcfg)
        return jp, loss, grads, {"params": new_params, "opt": new_opt}, (
            logits, cache, logits2, logits3, cache3)

    # one compile for all of it: the compiles are most of the file's time
    reference = jax.jit(reference)
    jp, loss, grads, new_state, served = reference(jax.random.PRNGKey(0), jb)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return dict(arch=arch, jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                batch=batch, api=api, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads),
                new_state=jax.tree.map(np.asarray, new_state),
                served=jax.tree.map(np.asarray, served))


# ---------------------------------------------------------------- model


def test_reduced_init_tree_and_dtypes_match_the_reference(ref):
    arch, tcfg, want = ref["arch"], ref["tcfg"], ref["jp"]
    tinit = _fns(arch, thy)[0]
    got = tinit(torch.Generator().manual_seed(0), tcfg, "cpu")
    wf = jax.tree_util.tree_flatten_with_path(want)[0]
    gf = tree.flatten_with_path(got)
    assert [tuple(getattr(k, "key", None) for k in p) for p, _ in wf] == [p for p, _ in gf]
    assert [(tuple(a.shape), str(a.dtype)) for _, a in wf] \
        == [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in gf]
    stacks = ("layers",) if arch == "mamba2-370m" else ("blocks", "tail")
    lead = {"layers": (tcfg.n_layers,)} if arch == "mamba2-370m" else {
        "blocks": (tcfg.n_blocks, tcfg.block_len), "tail": (tcfg.n_tail,)}
    for name in stacks:
        ssm = got[name]["ssm"]
        assert tuple(ssm["in_proj"]["w"].shape[:len(lead[name])]) == lead[name]
        for leaf in ("A_log", "D", "dt_bias", "conv_b", "norm_g"):    # deterministic
            np.testing.assert_array_equal(ssm[leaf].numpy(), np.asarray(
                want[name]["ssm"][leaf]).astype(np.float32))
    # the same tree in bf16: A_log, D and dt_bias stay f32, the rest bf16
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    ssm = tinit(torch.Generator(), bf, "meta")[stacks[0]]["ssm"]
    f32, bf16 = torch.float32, torch.bfloat16
    assert {"/".join(p): t.dtype for p, t in tree.flatten_with_path(ssm)} == {
        "A_log": f32, "D": f32, "dt_bias": f32, "conv_b": bf16, "conv_w": bf16,
        "in_proj/w": bf16, "norm_g": bf16, "out_proj/w": bf16}


# the full configs' parameter counts, bytes (bf16 with three f32 leaves per
# layer) and the cache at B = 16, max_len 1,024, from jax.eval_shape of the
# reference's init and make_cache
FULL = {"mamba2-370m": (381_214_208, 762_437_632, 815_923_200),
        "zamba2-1.2b": (1_121_330_048, 2_242_674_688, 1_458_249_728)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameters_and_cache_on_the_meta_device_match_the_reference(arch):
    jcfg, tcfg = JARCHS[arch].config(), get_arch(arch).config()
    jinit, _, jcache, _, _ = _fns(arch, jhy)
    tinit, _, tcache, _, _ = _fns(arch, thy)
    want = jax.tree.leaves(jax.eval_shape(functools.partial(jinit, cfg=jcfg),
                                          jax.random.PRNGKey(0)))
    got = tree.leaves(tinit(torch.Generator(), tcfg, "meta"))
    assert [(tuple(a.shape), str(a.dtype)) for a in want] \
        == [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in got]
    n = sum(t.numel() for t in got)
    nbytes = sum(t.numel() * t.element_size() for t in got)
    wcache = jax.tree.leaves(jax.eval_shape(lambda: jcache(jcfg, 16, 1024)))
    gcache = tree.leaves(tcache(tcfg, 16, 1024, "meta"))
    assert [(tuple(a.shape), str(a.dtype)) for a in wcache] \
        == [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in gcache]
    cache_bytes = sum(t.numel() * t.element_size() for t in gcache)
    assert (n, nbytes, cache_bytes) == FULL[arch]
    if arch == "mamba2-370m":      # O(1) in the length: the same at 8,192
        assert sum(t.numel() * t.element_size()
                   for t in tree.leaves(tcache(tcfg, 16, 8192, "meta"))) == cache_bytes


def test_the_archs_optimizers_accumulation_and_api_match_the_reference():
    for arch in ARCHS:
        jcfg = JARCHS[arch].config(reduced=True)
        want = JARCHS[arch].api(jcfg)
        got = get_arch(arch).api(get_arch(arch).config(reduced=True), device="cpu")
        assert got.optimizer.init_leaf.__qualname__.split(".")[0] \
            == want.optimizer.init_leaf.__qualname__.split(".")[0] == "adam"
        assert (got.accum, got.accum_dtype, got.sub_quadratic) \
            == (want.accum, want.accum_dtype, want.sub_quadratic)
    assert get_arch("mamba2-370m").api(get_arch("mamba2-370m").config(), "meta").accum == 2
    assert get_arch("zamba2-1.2b").api(get_arch("zamba2-1.2b").config(), "meta").accum == 2


def test_loss_and_gradients_match_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    tloss = _fns(ref["arch"], thy)[1]
    (loss, metrics), grads = value_and_grad(lambda p, b: tloss(p, b, tcfg))(
        tp, _tb(ref["batch"]))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert sorted(metrics) == ["xent"] and float(metrics["xent"]) == float(loss)
    for (path, g), want in zip(tree.flatten_with_path(grads), jax.tree.leaves(ref["grads"])):
        _rel_close(g, want)
    if ref["arch"] == "zamba2-1.2b":    # the shared block's gradient sums its applications
        assert float(grads["shared"]["attn"]["wq"]["w"].abs().max()) > 0


def test_remat_and_the_plain_forward_give_the_same_gradients(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    tloss = _fns(ref["arch"], thy)[1]
    batch = _tb(ref["batch"])
    _, g_remat = value_and_grad(lambda p, b: tloss(p, b, tcfg))(tp, batch)
    plain = dataclasses.replace(tcfg, remat=False)
    _, g_plain = value_and_grad(lambda p, b: tloss(p, b, plain))(tp, batch)
    for a, b in zip(tree.leaves(g_remat), tree.leaves(g_plain)):
        assert torch.equal(a, b)


def test_one_optimizer_step_matches_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    api = ref["tmod"].api(tcfg, device="cpu")
    state, metrics = make_train_step(api.loss_fn, api.optimizer)(init_state(tp, api.optimizer),
                                                                 _tb(ref["batch"]))
    assert abs(float(metrics["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    want_opt = ref["new_state"]["opt"]
    assert [sorted(s) for s in state["opt"]] == [sorted(s) for s in want_opt]
    for got, want in zip(state["opt"], want_opt):
        for k in got:
            _rel_close(got[k], want[k])
    for got, want in zip(tree.leaves(state["params"]),
                         jax.tree.leaves(ref["new_state"]["params"])):
        _rel_close(got, want)


def test_prefill_decode_and_the_cache_match_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    _, _, make, prefill, decode = _fns(ref["arch"], thy)
    logits, cache, logits2, logits3, cache3 = ref["served"]
    tokens = _t(ref["batch"]["tokens"])
    with torch.inference_mode():
        c = make(tcfg, B, S + 8, "cpu")
        flat, wflat = tree.flatten_with_path(c), jax.tree_util.tree_flatten_with_path(cache)[0]
        assert [p for p, _ in flat] == [tuple(k.key for k in p) for p, _ in wflat]
        assert all(tuple(t.shape) == a.shape for (_, t), (_, a) in zip(flat, wflat))
        held = tree.leaves(c)
        got, c = prefill(tp, tokens, c, tcfg)
        _rel_close(got, logits)
        assert got.dtype == torch.float32 and got.shape == (B, 1, tcfg.vocab)
        for t, want in zip(tree.leaves(c), jax.tree.leaves(cache)):
            _rel_close(t, want)
        got2, c = decode(tp, tokens[:, -1:], S, c, tcfg)
        _rel_close(got2, logits2)
        got3, c = decode(tp, tokens[:, -2:-1], S + 1, c, tcfg)
        _rel_close(got3, logits3)
        for t, want in zip(tree.leaves(c), jax.tree.leaves(cache3)):
            _rel_close(t, want)
        assert all(a is b for a, b in zip(tree.leaves(c), held))      # written in place
    if ref["arch"] == "mamba2-370m":
        assert sorted(c) == ["conv", "ssm"] and c["ssm"].dtype == torch.float32
    else:
        assert sorted(c) == ["blocks", "kv", "tail"]
        assert tuple(c["kv"]["k"].shape) == (tcfg.n_blocks, B, S + 8, tcfg.n_kv_heads,
                                             tcfg.d_head)


def test_prefill_logits_equal_the_plain_forward_and_k1_takes_the_vocabulary(ref, monkeypatch):
    from repro_torch.kernels import ops

    tcfg, tp = ref["tcfg"], ref["tp"]
    _, _, make, prefill, _ = _fns(ref["arch"], thy)
    forward = thy.mamba_forward if ref["arch"] == "mamba2-370m" else thy.hybrid_forward
    calls = []
    real = ops.qr_lookup_grouped
    monkeypatch.setattr(ops, "qr_lookup_grouped", lambda *a: calls.append(1) or real(*a))
    tokens = _t(ref["batch"]["tokens"])
    with torch.inference_mode():
        got, _ = prefill(tp, tokens, make(tcfg, B, S, "cpu"), tcfg)
        h = forward(tp, tlm.embed_tokens(tp, tokens, tcfg), tcfg)
        want = (h[:, -1:] @ tp["lm_head"]["w"]).float()
    assert calls == [1]
    assert torch.equal(got, want)


def test_a_prompt_shorter_than_the_conv_window_is_refused(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    _, _, make, prefill, _ = _fns(ref["arch"], thy)
    with torch.inference_mode(), pytest.raises(ValueError, match="d_conv - 1"):
        prefill(tp, torch.ones((1, 2), dtype=torch.long), make(tcfg, 1, 8, "cpu"), tcfg)


@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_the_reference(ref, reduced):
    tcfg = ref["tmod"].config(reduced=reduced)
    got, jwant = dataclasses.asdict(tcfg), dataclasses.asdict(ref["jmod"].config(reduced=reduced))
    assert got.pop("embedding") == jwant.pop("embedding")
    assert got == jwant
    assert (ref["tmod"].FAMILY, ref["tmod"].PARAMS_B) == (ref["jmod"].FAMILY,
                                                          ref["jmod"].PARAMS_B)
    assert (tcfg.pdtype, tcfg.cdtype) == ((torch.float32,) * 2 if reduced
                                          else (torch.bfloat16,) * 2)


# ---------------------------------------------------------------- serving engine


def _queue(engine):
    uids = [engine.submit([1, 2, 3, 4, 5], max_new_tokens=6) for _ in range(5)]
    uids += [engine.submit([9, 8, 7, 6, 5, 4, 3, 2, 1], max_new_tokens=20) for _ in range(3)]
    return uids


def test_greedy_engine_matches_the_reference_token_for_token(ref):
    arch, jcfg, tcfg, jp, tp = ref["arch"], ref["jcfg"], ref["tcfg"], ref["jp"], ref["tp"]
    _, _, jcache, jprefill, jdecode = _fns(arch, jhy)
    _, _, tcache, tprefill, tdecode = _fns(arch, thy)
    kw = dict(batch_size=4, max_len=20)
    je = JaxEngine(prefill_fn=jax.jit(lambda t, c: jprefill(jp, t, c, jcfg)),
                   decode_fn=jax.jit(lambda t, pos, c: jdecode(jp, t, pos, c, jcfg)),
                   make_cache_fn=lambda b, ml: jcache(jcfg, b, ml), **kw)
    record = []

    def logged(fn):
        def call(*args):
            logits, cache = fn(*args)
            record.append(logits[:, -1].clone())
            return logits, cache
        return call

    te = ServeEngine(prefill_fn=logged(lambda t, c: tprefill(tp, t, c, tcfg)),
                     decode_fn=logged(lambda t, pos, c: tdecode(tp, t, pos, c, tcfg)),
                     make_cache_fn=lambda b, ml: tcache(tcfg, b, ml, "cpu"),
                     device="cpu", **kw)
    uids = _queue(je), _queue(te)
    want, got = je.run_until_drained(), te.run_until_drained()
    assert uids[0] == uids[1] and set(got) == set(want) == set(uids[0])
    assert {u: got[u].output for u in got} == {u: want[u].output for u in want}
    assert [len(got[u].output) for u in uids[1]] == [6] * 5 + [11] * 3
    # the step logits that chose tokens for real rows are never near-ties
    rows = [4] * 6 + [3] * 11 + [1] * 6
    assert len(record) == len(rows)
    for logits, n in zip(record, rows):
        top = torch.topk(logits[:n], 2, dim=-1).values
        assert float((top[:, 0] - top[:, 1]).min()) > TOL * float(logits[:n].abs().max())


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_the_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve, train

    done = serve.main(["--device", "cpu", "--arch", arch])
    assert len(done) == 12 and all(len(r.output) == 12 for r in done.values())
    hist = train.main(["--device", "cpu", "--arch", arch, "--steps", "3", "--batch", "4",
                       "--seq-len", "16", "--log-every", "1"])
    assert [s for s, _ in hist] == [0, 1, 2] and all(np.isfinite(x) for _, x in hist)
    init = _fns(arch, thy)[0]
    n = tlm.num_params(init(torch.Generator(), get_arch(arch).config(reduced=True), "meta"))
    out = capsys.readouterr().out
    assert f"{arch}: served 12 requests / 144 tokens" in out
    assert f"{arch}: {n:,} parameters (embedding=qr)" in out
