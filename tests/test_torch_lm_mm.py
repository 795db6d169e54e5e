"""The port's encoder–decoder and VLM (``repro_torch.models.{encdec, vlm}``,
``configs.{seamless_m4t_large_v2, llava_next_34b}``) held against the JAX
package on the reduced configs: JAX-initialised parameters carried across
by ``params_from_jax``, numpy-seeded batches with stub frames or patches,
the JAX results shared per arch (all of them from one compile).

Tolerances (f32): 1e-5 on the loss (``tests/test_kernels.py:12``), 1e-4 of
each tensor's largest magnitude through the whole stack (encoder memory,
projected patches, logits, caches, gradients, the optimizer step).  The
full configs' parameter trees and caches are held to ``jax.eval_shape``
of the reference's functions on the meta device.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.common import Shape as JShape
from repro.models import encdec as jed
from repro.models import vlm as jvl
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.loop import init_state as jax_init_state
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_arch
from repro_torch.configs.common import Shape
from repro_torch.convert import params_from_jax
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.models import vlm as tvl
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import init_state, make_train_step, value_and_grad

TOL = 1e-4
B, S = 2, 24                   # batch and text tokens
ENCDEC, VLM = "seamless-m4t-large-v2", "llava-next-34b"
ARCHS = (ENCDEC, VLM)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float64)


def _rel_close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    print(f"max |diff| {err:.3e} of {scale:.3e}")
    assert err <= tol * scale, (err, scale)


def _fns(arch, pkg):
    """(init, loss_fn, make_cache, prefill, decode_step) of the arch's model."""
    if arch == ENCDEC:
        return (pkg.encdec_init, pkg.encdec_loss_fn, pkg.encdec_make_cache,
                pkg.encdec_prefill, pkg.encdec_decode_step)
    return pkg.vlm_init, pkg.vlm_loss_fn, pkg.vlm_make_cache, pkg.vlm_prefill, pkg.vlm_decode_step


def _vocab(cfg):
    return getattr(cfg, "vocab", None) or cfg.lm.vocab


def _batch(arch, cfg, seed=0):
    """Tokens, labels and mask (B, S), and the stub input: frames (B,
    S // enc_ratio, d) or patches (B, n_patches, d), f32."""
    rng = np.random.default_rng(seed)
    vocab = _vocab(cfg)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    tokens[0, :2] = (0, vocab - 1)
    out = {"tokens": tokens, "labels": rng.integers(0, vocab, size=(B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if arch == ENCDEC:
        out["frames"] = (rng.normal(size=(B, S // cfg.enc_ratio, cfg.d_model)) * 0.1).astype(
            np.float32)
    else:
        out["patches"] = (rng.normal(size=(B, cfg.n_patches, cfg.lm.d_model)) * 0.1).astype(
            np.float32)
    return out


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


@functools.cache
def _reference(arch):
    """The reduced arch in both packages, one batch, and the JAX package's
    results on them from one compile: the stub stage (the encoder memory /
    the projected patches), loss and gradients, one step of the arch's
    optimizer, and prefill with two decode steps after it (the VLM's at
    both ``pos = S``, where the reference's engine decodes, and ``pos = P +
    S``, where its prefill ends)."""
    jmod, tmod = JARCHS[arch], get_arch(arch)
    jcfg, tcfg = jmod.config(reduced=True), tmod.config(reduced=True)
    jinit, jloss, jcache, jprefill, jdecode = _fns(arch, (jed if arch == ENCDEC else jvl))
    batch = _batch(arch, jcfg)
    api = jmod.api(jcfg)
    extra = "frames" if arch == ENCDEC else "patches"
    p = 0 if arch == ENCDEC else jcfg.n_patches

    def reference(key, jb):
        jp = jinit(key, jcfg)
        (loss, _), grads = jax.value_and_grad(lambda q, b: jloss(q, b, jcfg), has_aux=True)(
            jp, jb)
        state0 = jax_init_state(jp, api.optimizer)
        new_params, new_opt = api.optimizer.update(grads, state0["opt"], jp, state0["step"])
        stub = (jed.encode(jp, jb["frames"], jcfg) if arch == ENCDEC
                else jvl._project(jp, jb["patches"], jcfg))
        tokens = jb["tokens"]
        cache = jcache(jcfg, B, p + S + 8)
        logits, cache = jprefill(jp, jb[extra], tokens, cache, jcfg)
        decoded = []
        for pos in ((S,) if arch == ENCDEC else (S, p + S)):
            logits2, cache2 = jdecode(jp, tokens[:, -1:], pos, cache, jcfg)
            logits3, cache3 = jdecode(jp, tokens[:, -2:-1], pos + 1, cache2, jcfg)
            decoded.append((logits2, logits3, cache3))
        return jp, loss, grads, {"params": new_params, "opt": new_opt}, stub, (
            logits, cache, decoded)

    reference = jax.jit(reference)
    jp, loss, grads, new_state, stub, served = reference(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return dict(arch=arch, jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                batch=batch, p=p, loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                new_state=jax.tree.map(np.asarray, new_state), stub=np.asarray(stub),
                served=jax.tree.map(np.asarray, served))


@pytest.fixture(params=ARCHS)
def ref(request):
    return _reference(request.param)


def _paths_shapes_dtypes(jtree, ttree):
    want = jax.tree_util.tree_flatten_with_path(jtree)[0]
    got = tree.flatten_with_path(ttree)
    return ([(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), tuple(a.shape),
              str(a.dtype)) for p, a in want],
            [(p, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in got])


# ---------------------------------------------------------------- model


def test_reduced_init_tree_and_dtypes_match_the_reference(ref):
    init = _fns(ref["arch"], ted if ref["arch"] == ENCDEC else tvl)[0]
    got = init(torch.Generator().manual_seed(0), ref["tcfg"], "cpu")
    want, have = _paths_shapes_dtypes(ref["jp"], got)
    assert have == want
    # the stacks' leading axis is the layer count
    if ref["arch"] == ENCDEC:
        assert got["encoder"]["attn"]["wq"]["w"].shape[0] == ref["tcfg"].enc_layers
        assert got["decoder"]["cross_attn"]["wk"]["w"].shape[0] == ref["tcfg"].dec_layers
    else:
        assert got["lm"]["layers"]["mlp"]["wg"]["w"].shape[0] == ref["tcfg"].lm.n_layers


# the full configs' parameter counts and bytes (all bf16) and the cache at
# B = 16, max_len 1,024 in bytes summed over the leaves, from jax.eval_shape
# of the reference's init and make_cache (seamless's cross K/V, one zero
# tensor under both keys, counted twice)
FULL = {ENCDEC: (1_436_418_048, 2_872_836_096, 2_013_265_920),
        VLM: (34_147_642_368, 68_295_284_736, 4_026_531_840)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameters_and_cache_on_the_meta_device_match_the_reference(arch):
    jcfg, tcfg = JARCHS[arch].config(), get_arch(arch).config()
    jinit, _, jcache, _, _ = _fns(arch, jed if arch == ENCDEC else jvl)
    tinit, _, tcache, _, _ = _fns(arch, ted if arch == ENCDEC else tvl)
    got = tinit(torch.Generator(), tcfg, "meta")
    want, have = _paths_shapes_dtypes(
        jax.eval_shape(functools.partial(jinit, cfg=jcfg), jax.random.PRNGKey(0)), got)
    assert have == want
    leaves = tree.leaves(got)
    cache = tcache(tcfg, 16, 1024, "meta")
    want, have = _paths_shapes_dtypes(jax.eval_shape(lambda: jcache(jcfg, 16, 1024)), cache)
    assert have == want
    assert (sum(t.numel() for t in leaves), sum(t.numel() * t.element_size() for t in leaves),
            sum(t.numel() * t.element_size() for t in tree.leaves(cache))) == FULL[arch]
    if arch == VLM:       # one layer of the 60
        one = tinit(torch.Generator(), dataclasses.replace(
            tcfg, lm=dataclasses.replace(tcfg.lm, n_layers=1)), "meta")
        assert sum(t.numel() for t in leaves) - sum(
            t.numel() for t in tree.leaves(one)) == 59 * 557_856_768


@pytest.mark.parametrize("arch", ARCHS)
def test_the_apis_batches_and_prefill_inputs_match_the_reference(arch):
    jcfg = JARCHS[arch].config(reduced=True)
    want = JARCHS[arch].api(jcfg)
    got = get_arch(arch).api(get_arch(arch).config(reduced=True), device="cpu")
    kind = "adam" if arch == ENCDEC else "adafactor"
    assert got.optimizer.init_leaf.__qualname__.split(".")[0] \
        == want.optimizer.init_leaf.__qualname__.split(".")[0] == kind
    assert (got.accum, got.accum_dtype, got.sub_quadratic) \
        == (want.accum, want.accum_dtype, want.sub_quadratic) == (8, "float32", False)
    seq = 40 if arch == ENCDEC else 8 + 24
    jshape, tshape = JShape("t", seq, 3, "train"), Shape("t", seq, 3, "train")

    def structs(batch):
        return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in batch.items()}

    assert structs(got.train_batch(tshape)) == structs(want.train_batch(jshape))
    assert all(t.device.type == "meta" for t in got.train_batch(tshape).values())
    assert [structs({"x": t})["x"] for t in got.prefill_inputs(tshape)] \
        == [structs({"x": s})["x"] for s in want.prefill_inputs(jshape)]
    batch = got.batch_fn(1, tshape)
    assert structs(batch) == structs(want.batch_fn(1, jshape))
    assert list(batch) == list(want.batch_fn(1, jshape))
    stub = batch["frames" if arch == ENCDEC else "patches"]
    assert 0.05 < float(stub.float().std()) < 0.2          # frames_at / patches_at: N(0, 0.1²)
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])


def test_encode_matches_the_reference():
    r = _reference(ENCDEC)
    got = ted.encode(r["tp"], _t(r["batch"]["frames"]), r["tcfg"])
    _rel_close(got, r["stub"])


def test_project_matches_the_reference():
    r = _reference(VLM)
    got = tvl._project(r["tp"], _t(r["batch"]["patches"]), r["tcfg"])
    _rel_close(got, r["stub"])


def test_loss_and_gradients_match_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    tloss = _fns(ref["arch"], ted if ref["arch"] == ENCDEC else tvl)[1]
    (loss, metrics), grads = value_and_grad(lambda p, b: tloss(p, b, tcfg))(
        tp, _tb(ref["batch"]))
    print(f"loss {float(loss)!r} vs {ref['loss']!r}")
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert sorted(metrics) == ["xent"] and float(metrics["xent"]) == float(loss)
    assert [p for p, _ in tree.flatten_with_path(grads)] \
        == [p for p, _ in tree.flatten_with_path(tp)]
    for g, want in zip(tree.leaves(grads), jax.tree.leaves(ref["grads"])):
        _rel_close(g, want)
    stub = grads["frontend_proj" if ref["arch"] == ENCDEC else "proj1"]["w"]
    assert float(stub.abs().max()) > 0             # the stub stage is trained


def test_remat_and_the_plain_forward_give_the_same_gradients(ref):
    tcfg, tp, arch = ref["tcfg"], ref["tp"], ref["arch"]
    tloss = _fns(arch, ted if arch == ENCDEC else tvl)[1]
    plain = dataclasses.replace(tcfg, remat=False) if arch == ENCDEC else dataclasses.replace(
        tcfg, lm=dataclasses.replace(tcfg.lm, remat=False))
    _, g_remat = value_and_grad(lambda p, b: tloss(p, b, tcfg))(tp, _tb(ref["batch"]))
    _, g_plain = value_and_grad(lambda p, b: tloss(p, b, plain))(tp, _tb(ref["batch"]))
    for a, b in zip(tree.leaves(g_remat), tree.leaves(g_plain)):
        assert torch.equal(a, b)


def test_one_optimizer_step_matches_the_reference(ref):
    api = ref["tmod"].api(ref["tcfg"], device="cpu")
    state, metrics = make_train_step(api.loss_fn, api.optimizer)(
        init_state(ref["tp"], api.optimizer), _tb(ref["batch"]))
    assert abs(float(metrics["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    want_opt = ref["new_state"]["opt"]
    assert [sorted(s) for s in state["opt"]] == [sorted(s) for s in want_opt]
    for got, want in zip(state["opt"], want_opt):
        for k in got:
            _rel_close(got[k], want[k])
    for got, want in zip(tree.leaves(state["params"]),
                         jax.tree.leaves(ref["new_state"]["params"])):
        _rel_close(got, want)


def test_encdec_prefill_decode_and_the_caches_match_the_reference():
    r = _reference(ENCDEC)
    tcfg, tp, batch = r["tcfg"], r["tp"], r["batch"]
    logits, cache, [(logits2, logits3, cache3)] = r["served"]
    tokens, frames = _t(batch["tokens"]), _t(batch["frames"])
    s_enc = S // tcfg.enc_ratio
    with torch.inference_mode():
        c = ted.encdec_make_cache(tcfg, B, S + 8, "cpu")
        # the allocated cross K/V is (S + 8) // enc_ratio long, one tensor under both keys
        assert c["cross_k"] is c["cross_v"]
        assert tuple(c["cross_k"].shape) == (tcfg.dec_layers, B, (S + 8) // tcfg.enc_ratio,
                                             tcfg.n_kv_heads, tcfg.d_head)
        held = dict(c["self"])
        got, c = ted.encdec_prefill(tp, frames, tokens, c, tcfg)
        _rel_close(got, logits)
        assert got.dtype == torch.float32 and got.shape == (B, 1, tcfg.vocab)
        # prefill's cross K/V is the frames' length, as the reference's
        assert tuple(c["cross_k"].shape) == tuple(cache["cross_k"].shape) == (
            tcfg.dec_layers, B, s_enc, tcfg.n_kv_heads, tcfg.d_head)
        for t, want in zip(tree.leaves(c), jax.tree.leaves(cache)):
            _rel_close(t, want)
        got2, c = ted.encdec_decode_step(tp, tokens[:, -1:], S, c, tcfg)
        _rel_close(got2, logits2)
        got3, c = ted.encdec_decode_step(tp, tokens[:, -2:-1], S + 1, c, tcfg)
        _rel_close(got3, logits3)
        for t, want in zip(tree.leaves(c), jax.tree.leaves(cache3)):
            _rel_close(t, want)
        assert all(c["self"][k] is held[k] for k in held)         # written in place


@pytest.mark.parametrize("at", ["text", "after_patches"])
def test_vlm_prefill_and_decode_at_both_positions_match_the_reference(at):
    """``vlm_decode_step`` equals the reference's at ``pos = S`` (the
    reference's engine) and at ``pos = P + S`` (where the prefill ends)."""
    r = _reference(VLM)
    tcfg, tp, batch, p = r["tcfg"], r["tp"], r["batch"], r["p"]
    logits, cache, decoded = r["served"]
    logits2, logits3, cache3 = decoded[0 if at == "text" else 1]
    pos = S if at == "text" else p + S
    tokens, patches = _t(batch["tokens"]), _t(batch["patches"])
    with torch.inference_mode():
        c = tvl.vlm_make_cache(tcfg, B, p + S + 8, "cpu")
        held = dict(c)
        got, c = tvl.vlm_prefill(tp, patches, tokens, c, tcfg)
        _rel_close(got, logits)
        for t, want in zip(tree.leaves(c), jax.tree.leaves(cache)):
            _rel_close(t, want)
        # the prefill fills rows 0 .. P + S - 1 and nothing after
        assert float(c["k"][:, :, p + S - 1].abs().max()) > 0 and not c["k"][:, :, p + S:].any()
        got2, c = tvl.vlm_decode_step(tp, tokens[:, -1:], pos, c, tcfg)
        _rel_close(got2, logits2)
        got3, c = tvl.vlm_decode_step(tp, tokens[:, -2:-1], pos + 1, c, tcfg)
        _rel_close(got3, logits3)
        for t, want in zip(tree.leaves(c), jax.tree.leaves(cache3)):
            _rel_close(t, want)
        assert all(c[k] is held[k] for k in held)


def _teacher(arch, tp, tcfg, stub, seq):
    """The plain teacher-forced forward of the text ``seq`` after the stub
    input (``embed.apply``, the model's training forward): the final-normed
    hidden states of the text positions (B, St, D) and the LM head."""
    if arch == ENCDEC:
        h = ted.encdec_forward(tp, tlm.embed_tokens(tp, seq, tcfg), ted.encode(tp, stub, tcfg),
                               tcfg)
        return h, tp["lm_head"]["w"]
    h, _ = tvl.vlm_forward(tp, stub, tlm.embed_tokens(tp["lm"], seq, tcfg.lm), tcfg)
    return h[:, stub.shape[1]:], tp["lm"]["lm_head"]["w"]


def test_prefill_logits_equal_the_plain_forward_and_k1_takes_the_vocabulary(ref, monkeypatch):
    from repro_torch.kernels import ops

    arch, tcfg, tp = ref["arch"], ref["tcfg"], ref["tp"]
    _, _, make, prefill, _ = _fns(arch, ted if arch == ENCDEC else tvl)
    calls = []
    real = ops.qr_lookup_grouped
    monkeypatch.setattr(ops, "qr_lookup_grouped", lambda *a: calls.append(a[0].shape) or real(*a))
    tokens = _t(ref["batch"]["tokens"])
    stub = _t(ref["batch"]["frames" if arch == ENCDEC else "patches"])
    with torch.inference_mode():
        got, _ = prefill(tp, stub, tokens, make(tcfg, B, ref["p"] + S, "cpu"), tcfg)
        if arch == ENCDEC:     # the serving stack (cross K/V from the memory) on embed.apply
            h = ted._prefill_hidden(tp, tlm.embed_tokens(tp, tokens, tcfg),
                                    ted.encode(tp, stub, tcfg), make(tcfg, B, S, "cpu")["self"],
                                    tcfg)[0]
            head = tp["lm_head"]["w"]
        else:
            h, head = _teacher(arch, tp, tcfg, stub, tokens)
    assert calls == [(B * S, 1)]                     # one lookup, of the text tokens only
    assert torch.equal(got, (h[:, -1:] @ head).float())


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch, reduced):
    tmod, jmod = get_arch(arch), JARCHS[arch]
    got, jwant = (dataclasses.asdict(m.config(reduced=reduced)) for m in (tmod, jmod))
    inner = (lambda d: d) if arch == ENCDEC else (lambda d: d["lm"])
    assert inner(got).pop("embedding") == inner(jwant).pop("embedding")
    assert got == jwant
    assert (tmod.ARCH, tmod.FAMILY, tmod.PARAMS_B) == (jmod.ARCH, jmod.FAMILY, jmod.PARAMS_B)
    cfg = tmod.config(reduced=reduced)
    cfg = cfg if arch == ENCDEC else cfg.lm
    assert (cfg.pdtype, cfg.cdtype) == ((torch.float32,) * 2 if reduced
                                        else (torch.bfloat16,) * 2)


def test_the_registry_holds_the_references_archs_in_its_order():
    assert list(TARCHS) == list(JARCHS)
    assert get_arch(ENCDEC).config().name == ENCDEC and get_arch(VLM).config().name == VLM


# ---------------------------------------------------------------- serving engine


def _engine_fns(arch, pkg, params, cfg, offset, zeros, *device):
    """The launcher's closures over the model's functions: zero stub inputs
    before the tokens, the VLM's decode at ``pos + offset`` into a cache
    ``offset`` rows longer."""
    _, _, make, prefill, decode = _fns(arch, pkg)
    return (lambda t, c: prefill(params, zeros(t), t, c, cfg),
            lambda t, pos, c: decode(params, t, pos + offset, c, cfg),
            lambda b, ml: make(cfg, b, ml + offset, *device))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_engine_matches_the_reference_token_for_token(arch):
    """Both engines driven as the port's launcher drives them (zero stub
    inputs; the VLM decoding after its patch rows) give the same tokens."""
    r = _reference(arch)
    jcfg, tcfg, jp, tp, p = r["jcfg"], r["tcfg"], r["jp"], r["tp"], r["p"]
    d = jcfg.d_model if arch == ENCDEC else jcfg.lm.d_model

    def n(t):       # the stub's rows for a prompt of t.shape[1] tokens
        return t.shape[1] // jcfg.enc_ratio if arch == ENCDEC else p

    jpre, jdec, jmake = _engine_fns(arch, jed if arch == ENCDEC else jvl, jp, jcfg, p,
                                    lambda t: jnp.zeros((t.shape[0], n(t), d), jnp.bfloat16))
    kw = dict(batch_size=4, max_len=20)
    je = JaxEngine(prefill_fn=jax.jit(jpre), decode_fn=jax.jit(jdec), make_cache_fn=jmake, **kw)
    tpre, tdec, tmake = _engine_fns(
        arch, ted if arch == ENCDEC else tvl, tp, tcfg, p,
        lambda t: torch.zeros((t.shape[0], n(t), d), dtype=torch.bfloat16), "cpu")
    te = ServeEngine(prefill_fn=tpre, decode_fn=tdec, make_cache_fn=tmake, device="cpu", **kw)
    for e in (je, te):
        for _ in range(5):
            e.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=6)
        for _ in range(3):
            e.submit([9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8, 7], max_new_tokens=20)
    want, got = je.run_until_drained(), te.run_until_drained()
    assert {u: got[u].output for u in got} == {u: want[u].output for u in want}
    assert [len(got[u].output) for u in sorted(got)] == [6] * 5 + [8] * 3


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_the_arch_on_the_cpu(arch, capsys):
    """``_serve_lm`` serves the reduced arch on the CPU, each output the
    port's teacher-forced greedy continuation of its prompt after zero
    frames or patches (the VLM decodes after its patch rows); the training
    launcher takes three steps through ``api.batch_fn``."""
    from repro_torch.launch import serve, train

    done = serve.main(["--device", "cpu", "--arch", arch])
    assert len(done) == 12 and all(len(r.output) == 12 for r in done.values())
    mod = get_arch(arch)
    cfg = mod.config(reduced=True)
    params = mod.api(cfg, "cpu").init(torch.Generator(device="cpu").manual_seed(0))
    with torch.inference_mode():
        for plen in (4, 7):
            r = next(r for r in done.values() if len(r.prompt) == plen)
            seq = torch.tensor([r.prompt + r.output[:-1]])
            stub = torch.zeros((1, plen // cfg.enc_ratio if arch == ENCDEC else cfg.n_patches,
                                cfg.d_model if arch == ENCDEC else cfg.lm.d_model),
                               dtype=torch.bfloat16)
            h, head = _teacher(arch, params, cfg, stub, seq)
            assert (h[0, plen - 1:] @ head).argmax(-1).tolist() == r.output
    hist = train.main(["--device", "cpu", "--arch", arch, "--steps", "3", "--batch", "4",
                       "--seq-len", "32", "--log-every", "1"])
    assert [s for s, _ in hist] == [0, 1, 2] and all(np.isfinite(x) for _, x in hist)
    n = tlm.num_params(_fns(arch, ted if arch == ENCDEC else tvl)[0](
        torch.Generator(), cfg, "meta"))
    out = capsys.readouterr().out
    assert f"{arch}: served 12 requests / 144 tokens" in out
    assert f"{arch}: {n:,} parameters (embedding=qr)" in out
