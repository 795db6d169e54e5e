"""The program's own spans (``repro_torch.obs.trace.span``) at its layer
boundaries: the tree one DLRM ``predict`` and one DCN training step give,
what the spans cost while off (nothing: no clock, no profiler range, the
same bits), the backward ops of the embed stage found by sequence number
in a profile, and the tracer's origin on the profiler's clock."""

import dataclasses
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import EmbeddingSpec
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.models import dcn as tdcn
from repro_torch.models import dlrm as tdlrm
from repro_torch.obs import Obs, Tracer
from repro_torch.obs import trace as trace_mod
from repro_torch.optim.optimizers import adam
from repro_torch.train import loop as tloop

SIZES = (100, 500, 33, 2000)
QR = EmbeddingSpec(kind="qr", num_collisions=4, op="mult", threshold=0)
DLRM = tdlrm.DLRMConfig(table_sizes=SIZES, emb_dim=8, bottom_mlp=(32, 8), top_mlp=(32, 16),
                        embedding=QR)
DCN = tdcn.DCNConfig(table_sizes=SIZES, emb_dim=8, cross_layers=2, deep_mlp=(32, 16),
                     embedding=QR)


def _batch(step=0, b=16):
    return batch_at(0, step, b, CriteoSpec(table_sizes=SIZES), "cpu")


def _tree(events):
    """``(name, depth, which)`` of each event in start order."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    return [(e["name"], e["args"]["depth"], e["args"].get("which")) for e in evs]


def _dcn_step():
    params = tdcn.dcn_init(DCN, torch.Generator().manual_seed(0), "cpu")
    step = tloop.make_train_step(lambda p, b: tdcn.dcn_loss_fn(p, b, DCN), adam(1e-3))
    return step, tloop.init_state(params, adam(1e-3))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_spans_nest_inside_the_call(use_kernel):
    cfg = dataclasses.replace(DLRM, use_kernel=use_kernel)
    params = tdlrm.dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _batch()
    tracer = Tracer()
    with tracer.active(), torch.no_grad():
        with tracer.span("predict"):
            tdlrm.dlrm_forward(params, b["dense"], b["sparse"], cfg)
    assert _tree(tracer.events) == [
        ("predict", 0, None), ("repro.embed", 1, None), ("repro.mlp", 1, "bottom"),
        ("repro.interact", 1, None), ("repro.mlp", 1, "top")]
    outer = next(e for e in tracer.events if e["name"] == "predict")
    assert all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
               for e in tracer.events)


def test_kernel_launches_are_spans_inside_their_stage():
    """On ``meta`` operands (a stand-in for the card: the launchers run
    their checks and packing and hand the call to ``meta_call``), each
    launch of the kernel route is a ``repro.launch`` span naming its kernel
    inside the stage that made it."""
    cfg = dataclasses.replace(DLRM, use_kernel=True)
    params = tdlrm.dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = {k: [{name: x.to("meta") for name, x in d.items()} for d in v]
            for k, v in params.items()}
    idx = torch.zeros((2, len(SIZES)), dtype=torch.int32, device="meta")
    dense = torch.zeros((2, 13), device="meta")
    tracer = Tracer()
    with tracer.active(), torch.no_grad():
        tdlrm.dlrm_forward(meta, dense, idx, cfg)
    evs = sorted(tracer.events, key=lambda e: (e["ts"], -e["dur"]))
    names = [(e["name"], e["args"]["depth"], e["args"].get("kernel")) for e in evs]
    assert names == [("repro.embed", 0, None), ("repro.launch", 1, "qr_gather_grouped"),
                     ("repro.mlp", 0, None), ("repro.interact", 0, None),
                     ("repro.launch", 1, "dot_interaction_concat"), ("repro.mlp", 0, None)]
    assert [e["args"].get("ids") for e in evs if e["name"] == "repro.launch"] == [idx.numel(),
                                                                                  None]


def test_train_step_spans_split_forward_backward_and_optimizer():
    step, state = _dcn_step()
    tracer = Tracer()
    with tracer.active():
        step(state, _batch())
    assert _tree(tracer.events) == [
        ("repro.train.forward", 0, None), ("repro.embed", 1, None),
        ("repro.mlp", 1, "deep"), ("repro.mlp", 1, "out"),
        ("repro.train.backward", 0, None), ("repro.train.optimizer", 0, None)]


def test_trainer_with_obs_trace_records_the_step_spans():
    step, state = _dcn_step()
    obs = Obs(trace=True)
    trainer = tloop.Trainer(step, tloop.TrainConfig(num_steps=2, log_every=1),
                            batch_at=_batch, obs=obs)
    trainer.run(state)
    # the step number rides on the trainer's ``train_step`` event, which
    # holds that step's spans on the same clock
    steps = [e for e in obs.tracer.events if e["name"] == "train_step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    for name in ("forward", "backward", "optimizer"):
        inner = [e for e in obs.tracer.events if e["name"] == f"repro.train.{name}"]
        assert len(inner) == 2 and all(e["args"]["depth"] == 0 for e in inner)
        for s, e in zip(steps, inner):
            assert s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
    assert not [e for e in obs.tracer.events if e["name"] == "repro.train.step"]
    assert trace_mod.span("repro.embed") is trace_mod._NULL   # the run turned it off again


def test_active_tracer_is_per_thread():
    """Spans of another thread record nothing into a tracer made active
    here, and an ``active()`` block on that thread leaves this thread's
    tracer in place."""
    import threading

    mine, theirs = Tracer(), Tracer()

    def other():
        with trace_mod.span("repro.embed"):
            pass
        with theirs.active(), trace_mod.span("repro.mlp"):
            pass

    with mine.active():
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
        with trace_mod.span("repro.interact"):
            pass
    assert [e["name"] for e in mine.events] == ["repro.interact"]
    assert [e["name"] for e in theirs.events] == ["repro.mlp"]
    assert trace_mod.span("repro.embed") is trace_mod._NULL


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def test_spans_off_leave_no_profiler_event_and_the_same_bits():
    cfg = dataclasses.replace(DLRM, use_kernel=True)
    params = tdlrm.dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _batch()

    def score():
        with torch.no_grad():
            return tdlrm.dlrm_forward(params, b["dense"], b["sparse"], cfg)

    def train():
        step, state = _dcn_step()
        new, metrics = step(state, b)
        return metrics["loss"], new["params"]["cross"][0]["w"]

    for fn in (score, train):
        off, events = _profiled(fn)
        assert not [e.name() for e in events if e.name().startswith("repro.")]
        with Tracer(profiler_annotations=True).active():
            on, events = _profiled(fn)
        assert [e.name() for e in events if e.name().startswith("repro.")]
        off, on = (off, on) if isinstance(off, tuple) else ((off,), (on,))
        assert all(torch.equal(x, y) for x, y in zip(off, on))


def test_span_off_reads_no_clock_and_opens_no_range(monkeypatch):
    calls = []
    monkeypatch.setattr(trace_mod.time, "monotonic", lambda: calls.append("clock") or 0.0)
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: calls.append("range"))
    a, b = trace_mod.span("repro.embed"), trace_mod.span("repro.mlp", which="top")
    assert a is b                                # one shared null context
    with a, b:
        pass
    assert calls == []


def test_backward_ops_of_the_embed_stage_found_by_sequence_number():
    """Every backward op carries its forward op's ``sequence_nr`` and
    thread: the backward of the ops launched inside ``repro.embed`` (the
    table gathers) is found by that pair, and no MLP's backward is."""
    step, state = _dcn_step()
    with Tracer(profiler_annotations=True).active():
        _, events = _profiled(lambda: step(state, _batch()))
    spans = {}
    for e in events:
        if e.name().startswith("repro."):
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))

    def inside(name, e):
        return any(s <= e.start_ns() <= t and e.start_thread_id() == th
                   for s, t, th in spans[name])

    ops = [e for e in events if not e.name().startswith("repro.")]
    forward = [e for e in ops if e.fwd_thread_id() == 0 and e.sequence_nr() >= 0]
    latest = {}                                  # (thread, seq) -> the op that took the node
    for e in sorted(forward, key=lambda e: e.start_ns()):
        latest[(e.start_thread_id(), e.sequence_nr())] = e
    backward = [e for e in ops if e.name().startswith("autograd::engine::evaluate_function: ")]
    assert backward
    found = {}
    for e in backward:
        fwd = latest.get((e.fwd_thread_id(), e.sequence_nr()))
        for name in ("repro.embed", "repro.mlp"):
            if fwd is not None and inside(name, fwd):
                found.setdefault(name, set()).add(e.name().split(": ")[1])
    assert "IndexBackward0" in found["repro.embed"]
    assert {"MmBackward0", "ReluBackward0"} <= found["repro.mlp"]
    assert not found["repro.embed"] & {"MmBackward0", "ReluBackward0", "AddmmBackward0"}


def test_chrome_trace_origin_puts_spans_on_the_profiler_clock():
    """Shifted by the origin, a span starts where its profiler range does.
    Entering a range can take milliseconds on a loaded host (the first one
    above all), so of five spans the closest is held to 200 µs: a wrong
    origin moves every one."""
    tracer = Tracer(profiler_annotations=True)
    time.sleep(0.01)
    with tracer.active(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with trace_mod.span("repro.mark"):
                time.sleep(0.001)
    payload = json.loads(tracer.to_json())
    ours = sorted(payload["otherData"]["origin_unix_ns"] + ev["ts"] * 1e3
                  for ev in payload["traceEvents"])
    mirrored = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                      if e.name() == "repro.mark")
    assert len(ours) == len(mirrored) == 5
    assert min(abs(a - b) for a, b in zip(ours, mirrored)) < 200e3
