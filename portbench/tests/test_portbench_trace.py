"""The trace reduction on synthetic raw profiler events: the window
between the markers, the busy union, the device time of kernels by the
harness range their launch lies in (a ``ctypes`` launch has no op above
it), and idle gaps named by what the host was doing."""

import pytest
from torch.autograd import DeviceType

from portbench.lib import trace

MAIN = 1


class Ev:
    def __init__(self, name, dev, start, end, corr=0, thread=MAIN, annotation=False):
        self._v = (name, dev, start, end, corr, thread, annotation)

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


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def events():
    return [
        Ev("spin_kernel", GPU, 0, 100),
        Ev("portbench.embed", CPU, 110, 400, annotation=True),
        Ev("cudaLaunchKernel", CPU, 300, 310, corr=501),            # ctypes launch, no op
        Ev("uniform_kernel", GPU, 320, 420, corr=501),
        Ev("portbench.embed", GPU, 320, 420, annotation=True),      # the range on the device
        Ev("aten::mm", CPU, 450, 480),
        Ev("cudaLaunchKernel", CPU, 460, 470, corr=502),
        Ev("sgemm", GPU, 480, 700, corr=502),
        Ev("portbench.optimizer", CPU, 800, 900, annotation=True),
        Ev("aten::add", CPU, 820, 890),
        Ev("cudaLaunchKernel", CPU, 830, 840, corr=503, thread=2),  # another thread's launch
        Ev("add_kernel", GPU, 850, 900, corr=503),
        Ev("spin_kernel", GPU, 1000, 1100),
    ]


def test_reduce_reads_window_busy_ranges_and_gaps():
    tr = trace.reduce(events(), host_s=1e-6)
    assert tr.window_s == pytest.approx(900e-9)                     # 100 .. 1000
    assert tr.busy_s == pytest.approx((420 - 320 + 700 - 480 + 900 - 850) * 1e-9)
    assert tr.range_s["portbench.embed"] == pytest.approx(100e-9)
    assert tr.range_s["portbench.optimizer"] == 0.0                 # launched on thread 2
    assert tr.range_calls == {"portbench.embed": 1, "portbench.optimizer": 1}
    assert tr.device_ops == pytest.approx({"uniform_kernel": 100e-9, "sgemm": 220e-9,
                                           "add_kernel": 50e-9})
    # gaps: 100-320 (mid 210: in portbench.embed, no op), 420-480 (mid 450: aten::mm),
    # 700-850 (mid 775: nothing), 900-1000 (mid 950: nothing)
    assert tr.idle_gaps == pytest.approx({
        "portbench.embed > no host op": 220e-9, "outside ranges > aten::mm": 60e-9,
        "outside ranges > no host op": 250e-9})
    assert tr.top(tr.device_ops, 2) == [["sgemm", pytest.approx(220e-9)],
                                        ["uniform_kernel", pytest.approx(100e-9)]]


def test_reduce_reads_host_time_and_waits_by_range():
    evs = [
        Ev("portbench.step", CPU, 0, 1000, annotation=True),
        Ev("cudaLaunchKernel", CPU, 100, 110, corr=601),
        Ev("kernel", GPU, 120, 800, corr=601),
        Ev("cudaStreamSynchronize", CPU, 200, 900),                 # waits for the card
        Ev("cudaDeviceSynchronize", CPU, 300, 400, thread=2),       # another thread's wait
        Ev("cudaMemcpyAsync", CPU, 950, 990),
        Ev("portbench.step", CPU, 2000, 2500, annotation=True),
        Ev("cudaLaunchKernel", CPU, 2100, 2400),
        Ev("Command Buffer Full", CPU, 2110, 2390),                 # the launch queue is full
        Ev("cudaStreamSynchronize", CPU, 1100, 1200),               # between the steps
    ]
    tr = trace.reduce(evs, host_s=1e-6)
    assert tr.range_calls == {"portbench.step": 2}
    assert tr.range_host_s["portbench.step"] == pytest.approx(1500e-9)
    assert tr.range_wait_s["portbench.step"] == pytest.approx((700 + 40 + 280) * 1e-9)
    assert tr.range_s["portbench.step"] == pytest.approx(680e-9)
