"""The port's optimizers held against the reference's.

The same numpy gradients go through ``repro.optim.optimizers`` and
``repro_torch.optim.optimizers`` for several steps from the same
parameters; the parameters and every state leaf must agree.  The
reference's own tests (``tests/test_optim.py``) are mirrored on the port.

Tolerances (``tests/test_kernels.py:12``): f32 1e-5; bf16 parameters 3e-2
(one bf16 rounding of the updated parameter can land one bf16 step apart
when the f32 updates differ in their last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.convert import params_from_jax, state_to_numpy
from repro_torch.optim import optimizers as topt

TOL = {"float32": 1e-5, "bfloat16": 3e-2}

# (name, factory(module) -> Optimizer): one entry per optimizer and option
OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum_wd": lambda m: m.sgd(0.05, momentum=0.9, weight_decay=1e-3),
    "adagrad": lambda m: m.adagrad(0.5),
    "rowwise_adagrad": lambda m: m.rowwise_adagrad(0.5),
    "adam": lambda m: m.adam(0.1),
    "amsgrad_wd": lambda m: m.adam(0.1, amsgrad=True, weight_decay=1e-2),
    "adafactor": lambda m: m.adafactor(0.2),
    "adagrad_cosine": lambda m: m.adagrad(m.cosine_schedule(0.5, warmup=2, total=6)),
    "partitioned": lambda m: m.partitioned([(lambda p: "tables" in p, m.rowwise_adagrad(1e-2))],
                                           m.adam(1e-3, amsgrad=True)),
}


def _params(dtype):
    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    # dict keys out of order on purpose: both sides must flatten them sorted
    p = {"top": [{"w": arr(6, 3), "b": arr(3)}], "tables": [{"table_1": arr(4, 5),
                                                              "table_0": arr(9, 5)}],
         "bottom": [{"w": arr(2, 6), "b": arr(6)}]}
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), p)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32),
                                              p.dtype), params)


def _run_both(name, dtype, steps=6, tensor_step=False):
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = _params(dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(steps):
        jg = _grads(jp, step)
        tg = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
        tstep = torch.tensor(step, dtype=torch.int32) if tensor_step else step
        jp, js = jo.update(jg, js, jp, jnp.int32(step) if tensor_step else step)
        tp, ts = to.update(tg, ts, tp, tstep)
    return jp, js, tp, ts


def _assert_trees_close(jtree, ttree, tol):
    jleaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    tleaves = tree.leaves(state_to_numpy(ttree))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_params_and_state_match_reference(name, dtype):
    jp, js, tp, ts = _run_both(name, dtype)
    _assert_trees_close(jp, tp, TOL[dtype])
    _assert_trees_close(js, ts, TOL[dtype])
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        assert str(b.dtype) == f"torch.{a.dtype}"
    # state keys per leaf are the reference's
    assert [sorted(s) for s in ts] == [sorted(s) for s in js]


@pytest.mark.parametrize("name", ["adam", "adafactor", "adagrad_cosine"])
def test_int32_tensor_step_matches_reference(name):
    """A 0-d int32 step (the train state's) gives the f32 bias corrections
    and schedule values the reference computes from its int32 step."""
    jp, js, tp, ts = _run_both(name, "float32", tensor_step=True)
    _assert_trees_close(jp, tp, 1e-5)
    _assert_trees_close(js, ts, 1e-5)


def test_leaf_paths_and_state_structs_match_reference():
    jp = _params("float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert topt.leaf_paths(tp) == jopt.leaf_paths(jp)
    assert topt.leaf_paths(tp)[:2] == ["bottom/0/b", "bottom/0/w"]
    for name in OPTIMIZERS:
        want = jopt.state_structs(OPTIMIZERS[name](jopt), jp)
        got = topt.state_structs(OPTIMIZERS[name](topt), tp)
        assert all(x.device.type == "meta" for s in got for x in s.values())
        assert [{k: tuple(v.shape) for k, v in s.items()} for s in got] \
            == [{k: tuple(v.shape) for k, v in s.items()} for s in want]


def test_global_norm_and_clip_match_reference():
    jg = jax.tree.map(lambda x: 30 * x, _grads(_params("float32"), 0))
    tg = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    np.testing.assert_allclose(float(topt.global_norm(tg)), float(jopt.global_norm(jg)),
                               rtol=1e-5)
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    tc, tn = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    _assert_trees_close(jc, tc, 1e-5)


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 55, 99, 120])
def test_schedules_match_reference(step):
    j = jopt.cosine_schedule(1.0, warmup=10, total=100)(jnp.int32(step))
    t = topt.cosine_schedule(1.0, warmup=10, total=100)(torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    assert topt.constant_schedule(0.3)(step) == jopt.constant_schedule(0.3)(step)


# ------------------------------------- the reference's tests/test_optim.py

TARGET = torch.tensor([[1.0, -2.0], [3.0, 0.5]])


def _quad_loss(params):
    return torch.sum((params["w"] - TARGET) ** 2)


@pytest.mark.parametrize("opt", [
    topt.sgd(0.1), topt.sgd(0.05, momentum=0.9), topt.adagrad(0.5), topt.rowwise_adagrad(0.5),
    topt.adam(0.1), topt.adam(0.1, amsgrad=True), topt.adafactor(0.2),
])
def test_converges_on_quadratic(opt):
    params = {"w": torch.zeros((2, 2))}
    state = opt.init(params)
    for step in range(300):
        w = params["w"].clone().requires_grad_(True)
        grads = {"w": torch.autograd.grad(_quad_loss({"w": w}), w)[0]}
        params, state = opt.update(grads, state, params, step)
    np.testing.assert_allclose(params["w"].numpy(), TARGET.numpy(), atol=0.2)


def test_rowwise_state_is_per_row():
    opt = topt.rowwise_adagrad(0.1)
    params = {"table": torch.zeros((100, 16)), "bias": torch.zeros((7,))}
    shapes = [tuple(s["acc"].shape) for s in opt.init(params)]
    assert (7,) in shapes and (100, 1) in shapes


def test_adafactor_state_is_factored():
    st = topt.adafactor(0.1).init({"w": torch.zeros((64, 32))})[0]
    assert st["vr"].shape == (64,) and st["vc"].shape == (32,)


def test_partitioned_routes_by_path():
    opt = topt.partitioned([(lambda p: "tables" in p, topt.rowwise_adagrad(0.5))],
                           topt.adam(0.1))
    params = {"tables": [{"table_0": torch.zeros((10, 4))}], "mlp": {"w": torch.zeros((3, 3))}}
    state = opt.init(params)
    # dict keys flatten alphabetically: mlp (adam: m/v) before tables (rowwise acc)
    assert "m" in state[0] and state[0]["m"].shape == (3, 3)
    assert state[1]["acc"].shape == (10, 1)
    grads = tree.tree_map(torch.ones_like, params)
    new_params, _ = opt.update(grads, state, params, 0)
    assert not np.allclose(new_params["mlp"]["w"].numpy(), 0.0)


def test_clip_by_global_norm():
    clipped, norm = topt.clip_by_global_norm({"a": torch.full((10,), 100.0)}, 1.0)
    assert float(topt.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 100


def test_cosine_schedule_shape():
    sched = topt.cosine_schedule(1.0, warmup=10, total=100)
    assert float(sched(0)) < 0.2
    assert abs(float(sched(10)) - 1.0) < 0.1
    assert float(sched(99)) < 0.2
    assert float(topt.constant_schedule(0.3)(50)) == pytest.approx(0.3)


def test_bf16_params_stay_bf16():
    opt = topt.adam(0.1)
    params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    new_params, _ = opt.update({"w": torch.ones((4, 4), dtype=torch.bfloat16)},
                               opt.init(params), params, 0)
    assert new_params["w"].dtype == torch.bfloat16


def test_update_is_functional_and_leaves_no_graph():
    """A step returns new tensors with no autograd history, and the old
    parameters and state keep their values."""
    opt = topt.adagrad(0.5)
    params = {"w": torch.ones((3, 2))}
    state = opt.init(params)
    grads = {"w": torch.full((3, 2), 2.0, requires_grad=True)}
    new_params, new_state = opt.update(grads, state, params, 0)
    assert not new_params["w"].requires_grad and not new_state[0]["acc"].requires_grad
    assert torch.equal(params["w"], torch.ones((3, 2)))
    assert torch.equal(state[0]["acc"], torch.zeros((3, 2)))


def _adafactor_out_of_place(g, s, p, step, lr, eps=1e-30, clip_threshold=1.0, decay=0.8):
    """The Adafactor step written out of place, one new tensor per operation."""
    t = step + 1
    beta = 1.0 - (t.to(torch.float32) if torch.is_tensor(t) else float(t)) ** (-decay)
    g32 = g.to(torch.float32)
    g2 = torch.square(g32) + eps
    if g.dim() >= 2:
        vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
        vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
        ns = {"vr": vr, "vc": vc}
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)[..., None])
        u = g32 / torch.sqrt(torch.clamp(denom, min=eps))
    else:
        v = beta * s["v"] + (1 - beta) * g2
        ns = {"v": v}
        u = g32 / torch.sqrt(torch.clamp(v, min=eps))
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
    u = u / torch.clamp(rms / clip_threshold, min=1.0)
    return (p.to(torch.float32) + -lr * u).to(p.dtype), ns


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7,), (6, 5), (2, 3, 4, 5)])
def test_adafactor_in_place_step_is_bit_equal_to_the_out_of_place_formula(dtype, shape):
    # the in-place update (two leaf-sized f32 temporaries at most) computes
    # the same operations in the same order: the same bits, and the
    # gradient it was given is left as it was
    rng = np.random.default_rng(len(shape))
    opt = topt.adafactor(0.05)
    p = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    s = opt.init_leaf(p)
    for step in range(3):
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
        g_before = g.clone()
        got_p, got_s = opt.update_leaf(g, s, p, torch.tensor(step, dtype=torch.int32))
        want_p, want_s = _adafactor_out_of_place(g, s, p, torch.tensor(step, dtype=torch.int32),
                                                 0.05)
        assert torch.equal(g, g_before)
        assert got_p.dtype == dtype and torch.equal(got_p, want_p)
        assert sorted(got_s) == sorted(want_s)
        assert all(torch.equal(got_s[k], want_s[k]) for k in got_s)
        p, s = got_p, got_s
