"""The plain reference against the port (``repro_torch``) on the CPU at
small sizes: the int8 rule, the DLRM and DCN forward passes on f32 and
int8 tables, the loss, AMSGrad and Adagrad, and the first training
steps.  The parameters are the benchmark's own (``lib/params.make``)."""

import pytest
import torch
from conftest import tiny_conf

from portbench.lib import params as P
from portbench.lib import stream
from portbench.lib import tree as T
from portbench.models import dcn as dcn_model
from portbench.models import dlrm as dlrm_model
from portbench.reference import embed as E
from portbench.reference import loss as L
from portbench.reference import optim as O
from portbench.reference import train as ref_train

MODELS = {"tiny-dlrm": dlrm_model, "tiny-dcn": dcn_model}


def _batch(conf, n=96, seed=11):
    spec = stream.CriteoSpec(table_sizes=tuple(conf["table_sizes"]), zipf=1.5, noise=0.5)
    return stream.batch_at(seed, 0, n, spec, "cpu")


def test_int8_rule_bit_equal_to_the_port():
    from repro_torch.serve.quantize import quantize_table
    w = torch.randn(500, 16, generator=torch.Generator().manual_seed(3)) * 0.2
    w[7] = 0.0
    w[9] = torch.abs(w[9])                       # a row without negatives
    mine, port = E.quantize_rows(w), quantize_table(w)
    for k in ("q", "scale", "zp"):
        assert mine[k].dtype == port[k].dtype and torch.equal(mine[k], port[k]), k


def test_stream_is_the_port_stream():
    from repro_torch.data import criteo
    spec = stream.CriteoSpec(zipf=1.5, noise=0.5)
    mine = stream.batch_at(2147483659, 4, 300, spec, "cpu")
    port = criteo.batch_at(2147483659, 4, 300, criteo.CriteoSpec(zipf=1.5, noise=0.5), "cpu")
    assert stream.KAGGLE_TABLE_SIZES == criteo.KAGGLE_TABLE_SIZES
    for k in mine:
        assert torch.equal(mine[k], port[k]), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_layout_is_the_ports(name):
    conf, model = tiny_conf(name), MODELS[name]
    mine = P.make(model.layout(conf), 5, "cpu")
    port = model.port(conf, "cpu")
    init = {"tiny-dlrm": "dlrm_init", "tiny-dcn": "dcn_init"}[name]
    from repro_torch.models import dcn, dlrm
    mod = dlrm if name == "tiny-dlrm" else dcn
    theirs = getattr(mod, init)(port.cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(v.shape)) for p, v in T.items(mine)] == \
        [(p, tuple(v.shape)) for p, v in T.items(theirs)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_the_port(name, quant):
    from repro_torch.serve.quantize import quantize_params
    conf, model = tiny_conf(name), MODELS[name]
    params = P.make(model.layout(conf), 5, "cpu")
    batch = _batch(conf)
    port = model.port(conf, "cpu")
    served = quantize_params(params, "int8") if quant else params
    tables = [{k: E.quantize_rows(w) for k, w in t.items()} for t in params["tables"]] \
        if quant else None
    with torch.no_grad():
        got = port.predict(served, batch)
        want = model.reference_forward(params, batch["dense"], batch["sparse"], conf,
                                       tables=tables)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_matches_the_port(name):
    conf, model = tiny_conf(name), MODELS[name]
    params = P.make(model.layout(conf), 6, "cpu")
    batch = _batch(conf)
    loss, _ = model.port(conf, "cpu").loss_fn(params, batch)
    logits = model.reference_forward(params, batch["dense"], batch["sparse"], conf)
    assert torch.allclose(L.bce(logits, batch["label"]), loss, rtol=1e-6)


@pytest.mark.parametrize("kind", ["amsgrad", "adagrad"])
def test_optimizer_steps_match_the_port(kind):
    from repro_torch.optim import optimizers as opt
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(64, 16, generator=gen)
    hyper = {"amsgrad": {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
             "adagrad": {"lr": 1e-2, "eps": 1e-10}}[kind]
    port = opt.adam(amsgrad=True, **hyper) if kind == "amsgrad" else opt.adagrad(**hyper)
    init, rule = O.RULES[kind]
    mine_p, mine_s = p, init(p)
    state = port.init([p])
    theirs = [p]
    for t in range(1, 4):
        g = torch.randn(64, 16, generator=gen)
        mine_p, mine_s = rule(mine_p, g, mine_s, t, **hyper)
        theirs, state = port.update([g], state, theirs, torch.tensor(t - 1, dtype=torch.int32))
    assert torch.allclose(mine_p, theirs[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_first_steps_match_the_port(name):
    """The reference's three steps against ``make_train_step`` with the
    configuration's optimizer, from the same parameters on the same
    batches."""
    from repro_torch.train.loop import init_state, make_train_step
    conf, model = tiny_conf(name), MODELS[name]
    params = P.make(model.layout(conf), 7, "cpu")
    batches = [_batch(conf, 128, seed=s) for s in (1, 2, 3)]
    port = model.port(conf, "cpu")
    step = make_train_step(port.loss_fn, port.optimizer)
    state = init_state(params, port.optimizer)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    want = ref_train.steps(model.reference_forward, conf, params, batches, conf["optimizer"])
    change = [float(torch.linalg.vector_norm(a - b)) for (_, a), (_, b) in
              zip(T.items(state["params"]), T.items(params))]
    assert losses == pytest.approx(want.losses, rel=1e-5)
    assert change == pytest.approx(want.change, rel=1e-3, abs=1e-7)


def test_reference_leaves_params_unchanged():
    conf = tiny_conf("tiny-dcn")
    params = P.make(dcn_model.layout(conf), 8, "cpu")
    before = P.fingerprint(params)
    ref_train.steps(dcn_model.reference_forward, conf, params, [_batch(conf)],
                    conf["optimizer"])
    assert P.fingerprint(params) == before
