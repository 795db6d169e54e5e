"""The program's spans in the trace reduction, on synthetic raw profiler
events: a span's device and host seconds, a backward kernel launched on
autograd's own thread given to the forward span whose op made its node,
the harness's fields left as they were, the spans on only once
installed, and the MLPs' count."""

import json

import pytest
from conftest import REPO
from torch.autograd import DeviceType

from portbench.lib import mlp_cost, spans, trace

MAIN, AUTOGRAD = 1, 7
CPU, GPU = DeviceType.CPU, DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, corr=0, thread=MAIN, annotation=False, seq=-1,
                 fwd_thread=0):
        self._v = (name, dev, start, end, corr, thread, annotation, seq, fwd_thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def sequence_nr(self):
        return self._v[7]

    def fwd_thread_id(self):
        return self._v[8]


def step_events():
    """One training step: the forward with the embed stage inside it, the
    backward on autograd's thread, and the harness's ``portbench.step``."""
    return [
        Ev("spin_kernel", GPU, 0, 100),
        Ev("portbench.step", CPU, 100, 2000, annotation=True),
        Ev("repro.train.forward", CPU, 110, 600, annotation=True),
        Ev("repro.embed", CPU, 120, 300, annotation=True),
        Ev("aten::remainder", CPU, 130, 150, seq=41),            # makes no node: records 41
        Ev("aten::index", CPU, 160, 250, seq=41),                # makes node 41
        Ev("cudaLaunchKernel", CPU, 170, 180, corr=1),
        Ev("gather", GPU, 200, 260, corr=1),
        Ev("aten::mm", CPU, 320, 400, seq=42),                   # outside repro.embed
        Ev("cudaLaunchKernel", CPU, 330, 340, corr=2),
        Ev("sgemm", GPU, 400, 500, corr=2),
        Ev("repro.train.backward", CPU, 610, 1400, annotation=True),
        Ev("cudaLaunchKernel", CPU, 620, 630, corr=3),           # the loss's ones, this thread
        Ev("fill", GPU, 640, 650, corr=3),
        Ev("autograd::engine::evaluate_function: MmBackward0", CPU, 700, 800,
           thread=AUTOGRAD, seq=42, fwd_thread=MAIN),
        Ev("cudaLaunchKernel", CPU, 710, 720, corr=4, thread=AUTOGRAD),
        Ev("sgemm_bwd", GPU, 720, 900, corr=4),
        Ev("autograd::engine::evaluate_function: IndexBackward0", CPU, 900, 1300,
           thread=AUTOGRAD, seq=41, fwd_thread=MAIN),
        Ev("cudaLaunchKernel", CPU, 910, 920, corr=5, thread=AUTOGRAD),
        Ev("indexing_backward_kernel", GPU, 920, 1350, corr=5),
        Ev("cudaStreamSynchronize", CPU, 1000, 1390),             # the caller waits
        Ev("repro.train.optimizer", CPU, 1500, 1900, annotation=True),
        Ev("cudaLaunchKernel", CPU, 1510, 1520, corr=6),
        Ev("adam", GPU, 1520, 1600, corr=6),
        Ev("spin_kernel", GPU, 2100, 2200),
    ]


@pytest.fixture
def installed():
    spans.install()
    yield
    spans.uninstall()


def test_spans_read_device_and_host_seconds():
    sp = spans.reduce(step_events())
    assert sp.calls == {"repro.train.forward": 1, "repro.embed": 1, "repro.train.backward": 1,
                        "repro.train.optimizer": 1}
    assert sp.device_s(launched=["repro.train.forward"]) == pytest.approx(160e-9)
    assert sp.device_s(launched=["repro.embed"]) == pytest.approx(60e-9)
    assert sp.device_s(launched=["repro.train.optimizer"]) == pytest.approx(80e-9)
    assert sp.host_s["repro.train.backward"] == pytest.approx(790e-9)
    assert sp.wait_s["repro.train.backward"] == pytest.approx(390e-9)
    assert sp.wait_s["repro.train.forward"] == 0.0


def test_backward_kernels_on_another_thread_go_to_the_forward_span():
    sp = spans.reduce(step_events())
    # launched by IndexBackward0 on autograd's thread: node 41 was made inside repro.embed
    # (by aten::index, the last op to record 41), MmBackward0's node 42 outside it
    assert sp.device_s(backward=["repro.embed"]) == pytest.approx(430e-9)
    assert sp.device_s(backward=["repro.train.forward"]) == pytest.approx((180 + 430) * 1e-9)
    assert sp.device_s(launched=["repro.train.backward"], backward=["repro.train.forward"]) \
        == pytest.approx((10 + 180 + 430) * 1e-9)
    assert sp.device_s(backward=["repro.train.backward", "repro.train.optimizer"]) == 0.0


def test_the_harness_fields_stay_as_they_were_beside_program_spans(installed):
    evs = step_events()
    plain = [e for e in evs if not e.name().startswith("repro.")]
    with_spans, without = trace.reduce(evs, 1e-6), trace.reduce(plain, 1e-6)
    for field in ("window_s", "busy_s", "device_ops", "range_s", "range_calls",
                  "range_host_s", "range_wait_s"):
        assert getattr(with_spans, field) == getattr(without, field), field
    assert spans.of(without) is None                       # a program without spans
    assert spans.of(with_spans).calls["repro.embed"] == 1  # the events kept on the trace
    # the gap before the optimizer's kernel is named by the span open there
    assert "portbench.step > repro.train.optimizer" in with_spans.idle_gaps
    assert "portbench.step > no host op" in without.idle_gaps


def test_capture_turns_the_program_spans_on(installed):
    import torch

    from repro_torch.obs import trace as program

    def fn():
        with program.span("repro.embed"):
            return torch.ones(4).sum()

    _, tr = trace.capture(fn, "cpu")
    assert spans.of(tr).calls == {"repro.embed": 1}
    assert program.span("repro.embed") is program._NULL    # off again after the stretch
    assert spans.of(None) is None                          # an untraced run


def test_spans_are_on_only_once_installed():
    import torch

    from repro_torch.obs import trace as program

    def fn():
        with program.span("repro.embed"):
            return torch.ones(4).sum()

    spans.uninstall()
    plain = trace.capture, trace.reduce
    _, tr = trace.capture(fn, "cpu")
    assert spans.of(tr) is None                            # no events kept, no spans
    spans.install()
    spans.install()                                        # a second call changes nothing
    try:
        _, tr = trace.capture(fn, "cpu")
        assert spans.of(tr).calls == {"repro.embed": 1}
    finally:
        spans.uninstall()
    assert (trace.capture, trace.reduce) == plain


def test_mlp_count_of_the_kaggle_dlrm():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / next(c["file"] for c in bench["configs"]
                                   if c["name"] == "dlrm-kaggle-qr4")).read_text())
    mlps = mlp_cost.dlrm_mlps(conf)
    assert mlps == [[13, 512, 256, 64, 16], [367, 512, 256, 1]]
    assert mlp_cost.flops(mlps, 1) == 948_736
    layers = [(13, 512), (512, 256), (256, 64), (64, 16), (367, 512), (512, 256), (256, 1)]
    assert mlp_cost.nbytes(mlps, 10) == 4 * sum(10 * i + i * o + o + 10 * o for i, o in layers)
