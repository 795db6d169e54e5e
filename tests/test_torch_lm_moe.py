"""The port's LM with the MoE and MLA blocks (``repro_torch.models.lm``,
``configs.{deepseek_v2_236b, arctic_480b, qwen3_14b, yi_34b,
granite_8b}``) held against the JAX package on the reduced configs:
JAX-initialised parameters carried across by ``params_from_jax``,
numpy-seeded batches, the JAX results shared through module-scoped
fixtures (each JAX call jitted once per arch).

Tolerances (f32) as ``tests/test_torch_lm.py``: 1e-5 on the loss and the
aux loss, 1e-4 of each tensor's largest magnitude through the whole stack
(logits, caches, gradients, the Adafactor step).  The reduced MoE configs
drop routes at this batch (8 groups of 6 tokens, capacity 2 per expert),
so the comparison covers the dropped routes too.  The full configs'
parameter counts and bytes are held to ``jax.eval_shape`` of the
reference's ``init`` on the meta device.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.loop import init_state as jax_init_state
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import init_state, make_train_step, value_and_grad

TOL = 1e-4
B, S = 2, 24
ARCHS = ("deepseek-v2-236b", "arctic-480b", "qwen3-14b", "yi-34b", "granite-8b")
MOE_ARCHS = ARCHS[:2]


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
    results on them: loss and gradients, one step of the arch's optimizer,
    prefill and a decode step."""
    arch = request.param
    jmod, tmod = JARCHS[arch], get_arch(arch)
    jcfg, tcfg = jmod.config(reduced=True), tmod.config(reduced=True)
    init = jax.jit(functools.partial(jlm.init, cfg=jcfg))
    jp = init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    api = jmod.api(jcfg)
    grad = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))
    (loss, metrics), grads = grad(jp, jb)
    step = jax.jit(jax_make_train_step(api.loss_fn, api.optimizer))
    new_state, _ = step(jax_init_state(jp, api.optimizer), jb)

    def serve(p, tokens):
        cache = jlm.make_decode_cache(jcfg, B, S + 8)
        logits, cache = jlm.prefill(p, tokens, cache, jcfg)
        logits2, cache2 = jlm.decode_step(p, tokens[:, -1:], S, cache, jcfg)
        return logits, cache, logits2, cache2

    serve = jax.jit(serve)
    served = serve(jp, jb["tokens"])
    return dict(arch=arch, jmod=jmod, tmod=tmod, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                batch=batch, api=api, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads),
                new_state=jax.tree.map(np.asarray, new_state),
                served=jax.tree.map(np.asarray, served))


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_init_tree_and_dtypes_match_the_reference(arch):
    jcfg, tcfg = JARCHS[arch].config(reduced=True), get_arch(arch).config(reduced=True)
    want = jax.eval_shape(functools.partial(jlm.init, cfg=jcfg), jax.random.PRNGKey(0))
    got = tlm.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    wf = jax.tree_util.tree_flatten_with_path(want)[0]
    gf = tree.flatten_with_path(got)
    assert [tuple(getattr(k, "key", None) for k in p) for p, _ in wf] == [p for p, _ in gf]
    assert [(tuple(a.shape), str(a.dtype)) for _, a in wf] \
        == [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in gf]
    layer = got["layers"]
    assert layer["moe"]["router"]["w"].dtype == torch.float32
    assert ("shared_mlp" in layer) == (arch == "deepseek-v2-236b")
    assert ("dense_mlp" in layer) == (arch == "arctic-480b")
    assert ("wkv_a" in layer["attn"]) == (arch == "deepseek-v2-236b")


# the full configs' parameter counts and bytes (bf16), from jax.eval_shape of
# the reference's init
FULL = {"deepseek-v2-236b": (238_982_374_400, 478_063_052_800),
        "arctic-480b": (476_678_272_000, 953_420_769_280),
        "qwen3-14b": (14_184_893_440, 28_369_786_880),
        "yi-34b": (34_044_881_920, 68_089_763_840),
        "granite-8b": (8_103_710_720, 16_207_421_440)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameters_on_the_meta_device_match_the_reference(arch):
    jcfg, tcfg = JARCHS[arch].config(), get_arch(arch).config()
    cuts = {"deepseek-v2-236b": (None, 4), "arctic-480b": (None, 1)}.get(arch, (None,))
    for n_layers in cuts:
        jc = jcfg if n_layers is None else dataclasses.replace(jcfg, n_layers=n_layers)
        tc = tcfg if n_layers is None else dataclasses.replace(tcfg, n_layers=n_layers)
        want = jax.tree.leaves(jax.eval_shape(functools.partial(jlm.init, cfg=jc),
                                              jax.random.PRNGKey(0)))
        got = tlm.init(torch.Generator(), tc, "meta")
        n = tlm.num_params(got)
        nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(got))
        assert n == sum(int(np.prod(a.shape)) for a in want)
        assert nbytes == sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in want)
        assert [tuple(a.shape) for a in want] == [tuple(t.shape) for t in tree.leaves(got)]
        if n_layers is None:
            assert (n, nbytes) == FULL[arch]
    # the cuts chip_smoke.py loads: DeepSeek-V2 at 4 of 60 layers, Arctic at 1 of 35
    if arch == "deepseek-v2-236b":
        assert (n, nbytes) == (16_543_851_520, 33_094_256_640)
    if arch == "arctic-480b":
        assert (n, nbytes) == (13_897_942_016, 27_797_719_040)


def test_the_archs_optimizers_and_accumulation_match_the_reference():
    for arch in ARCHS:
        jcfg = JARCHS[arch].config(reduced=True)
        want = JARCHS[arch].api(jcfg)
        got = get_arch(arch).api(get_arch(arch).config(reduced=True), device="cpu")
        assert got.optimizer.init_leaf.__qualname__.split(".")[0] \
            == want.optimizer.init_leaf.__qualname__.split(".")[0], arch
        assert (got.accum, got.accum_dtype) == (want.accum, want.accum_dtype), arch
    kinds = {arch: get_arch(arch).api(get_arch(arch).config(reduced=True), "cpu")
             for arch in ARCHS}
    assert {a: (k.optimizer.init_leaf.__qualname__.split(".")[0], k.accum, k.accum_dtype)
            for a, k in kinds.items()} == {
        "deepseek-v2-236b": ("adafactor", 16, "bfloat16"),
        "arctic-480b": ("adafactor", 8, "bfloat16"), "yi-34b": ("adafactor", 8, "float32"),
        "qwen3-14b": ("adam", 2, "float32"), "granite-8b": ("adam", 2, "float32")}


def test_loss_aux_and_gradients_match_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    (loss, metrics), grads = value_and_grad(lambda p, b: tlm.loss_fn(p, b, tcfg))(
        tp, _tb(ref["batch"]))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for k in ("xent", "aux"):
        assert abs(float(metrics[k]) - ref["metrics"][k]) <= 1e-5 * max(
            abs(ref["metrics"][k]), 1e-30), k
    if tcfg.moe is not None:
        assert float(metrics["aux"]) > 0
        assert float(loss) == pytest.approx(float(metrics["xent"]) + float(metrics["aux"]))
    else:
        assert float(metrics["aux"]) == 0.0
    for (path, g), want in zip(tree.flatten_with_path(grads), jax.tree.leaves(ref["grads"])):
        _rel_close(g, want)


def test_one_optimizer_step_matches_the_reference(ref):
    tcfg, tp = ref["tcfg"], ref["tp"]
    api = ref["tmod"].api(tcfg, device="cpu")
    assert type(api.optimizer).__name__ == type(ref["api"].optimizer).__name__
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
    logits, cache, logits2, cache2 = ref["served"]
    tokens = _t(ref["batch"]["tokens"])
    keys = ("ckv", "krope") if tcfg.mla is not None else ("k", "v")
    with torch.inference_mode():
        c = tlm.make_decode_cache(tcfg, B, S + 8, "cpu")
        assert sorted(c) == sorted(cache) == sorted(keys)
        assert all(c[k].shape == cache[k].shape and c[k].dtype == tcfg.cdtype for k in keys)
        held = dict(c)
        got, c = tlm.prefill(tp, tokens, c, tcfg)
        _rel_close(got, logits)
        assert got.dtype == torch.float32 and got.shape == (B, 1, tcfg.vocab)
        for k in keys:
            _rel_close(c[k], cache[k])
        got2, c = tlm.decode_step(tp, tokens[:, -1:], S, c, tcfg)
        _rel_close(got2, logits2)
        for k in keys:
            _rel_close(c[k], cache2[k])
            assert c[k] is held[k]                 # written in place
    if tcfg.mla is not None:                        # the latent cache: kv_lora + d_rope
        assert tuple(c["ckv"].shape) == (tcfg.n_layers, B, S + 8, tcfg.mla.kv_lora)
        assert tuple(c["krope"].shape) == (tcfg.n_layers, B, S + 8, tcfg.mla.d_rope)


@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_the_reference(ref, reduced):
    tcfg = ref["tmod"].config(reduced=reduced)
    want = {"qwen3-14b": (True, 1e6), "yi-34b": (False, 1e4), "granite-8b": (False, 1e4),
            "deepseek-v2-236b": (False, 1e4), "arctic-480b": (False, 1e4)}[ref["arch"]]
    assert (tcfg.qk_norm, tcfg.rope_theta) == want
    got, jwant = dataclasses.asdict(tcfg), dataclasses.asdict(ref["jmod"].config(reduced=reduced))
    assert got.pop("embedding") == jwant.pop("embedding")
    assert got == jwant
    assert (ref["tmod"].FAMILY, ref["tmod"].PARAMS_B) == (ref["jmod"].FAMILY,
                                                          ref["jmod"].PARAMS_B)
    if tcfg.qk_norm and reduced:
        assert "q_norm" in ref["tp"]["layers"]["attn"] and "k_norm" in ref["tp"]["layers"]["attn"]


# ---------------------------------------------------------------- serving engine


def _queue(engine):
    uids = [engine.submit([1, 2, 3, 4, 5], max_new_tokens=6) for _ in range(5)]
    uids += [engine.submit([9, 8, 7, 6, 5, 4, 3, 2, 1], max_new_tokens=20) for _ in range(3)]
    return uids


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_engine_matches_the_reference_token_for_token(arch):
    jmod, tmod = JARCHS[arch], get_arch(arch)
    jcfg, tcfg = jmod.config(reduced=True), tmod.config(reduced=True)
    init = jax.jit(functools.partial(jlm.init, cfg=jcfg))
    jp = init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(batch_size=4, max_len=20)
    je = JaxEngine(prefill_fn=jax.jit(lambda t, c: jlm.prefill(jp, t, c, jcfg)),
                   decode_fn=jax.jit(lambda t, pos, c: jlm.decode_step(jp, t, pos, c, jcfg)),
                   make_cache_fn=lambda b, ml: jlm.make_decode_cache(jcfg, b, ml), **kw)
    record = []

    def logged(fn):
        def call(*args):
            logits, cache = fn(*args)
            record.append(logits[:, -1].clone())
            return logits, cache
        return call

    te = ServeEngine(prefill_fn=logged(lambda t, c: tlm.prefill(tp, t, c, tcfg)),
                     decode_fn=logged(lambda t, pos, c: tlm.decode_step(tp, t, pos, c, tcfg)),
                     make_cache_fn=lambda b, ml: tlm.make_decode_cache(tcfg, b, ml, "cpu"),
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
    n = tlm.num_params(tlm.init(torch.Generator(), get_arch(arch).config(reduced=True), "meta"))
    out = capsys.readouterr().out
    assert f"{arch}: served 12 requests / 144 tokens" in out
    assert f"{arch}: {n:,} parameters (embedding=qr)" in out
