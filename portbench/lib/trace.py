"""One ``torch.profiler`` capture of a steady stretch, reduced to what the
per-layer readers and the result line need.

The stretch runs between two marker kernels (``torch.cuda._sleep``), each
behind a synchronise: the trace can miss a window's first launch, and the
markers fix the window on the device's own clock.  From the device events
(kernels, copies, sets; not the markers, not user annotations):

  * ``window_s``: from the first marker's end to the last marker's start;
  * ``busy_s``: the union of the device events' intervals in the window;
  * ``device_ops``: seconds by kernel name;
  * ``range_s``: device seconds of every device event whose launch (the
    runtime call, ``cuda*`` or ``cu*``, that shares its correlation id)
    lies inside a harness range (``record_function``) on the range's
    thread, and ``range_calls``.  The launch is matched by time, not by
    the profiler's op tree: a kernel launched through ``ctypes`` has no
    op above it to link to;
  * ``range_host_s``: host seconds inside each harness range, and
    ``range_wait_s`` the part of them its thread spent waiting for the
    device: in a runtime call that synchronises or copies (``WAITS``), or
    in a launch held until the device's queue drains (the profiler's
    ``Command Buffer Full``, ``STALL``);
  * ``idle_gaps``: idle seconds by what the host was doing: the harness
    range and the innermost host operation open at each gap's middle.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

PREFIX = "portbench."
_MARK_CYCLES = 1_000_000
_GAPS_NAMED = 400
WAITS = ("Synchronize", "Memcpy")
STALL = "Command Buffer Full"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    host_s: float
    device_ops: dict
    range_s: dict
    range_calls: dict
    range_host_s: dict
    range_wait_s: dict
    idle_gaps: dict

    def top(self, table: dict, k: int = 10) -> list:
        return [[name, s] for name, s in sorted(table.items(), key=lambda kv: -kv[1])[:k]]


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def capture(fn, device):
    """``fn()`` under the profiler between the markers; returns
    ``(fn's result, Trace)``.  On a CPU device (the harness's own tests)
    there are no markers and no device events."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def mark():
        if cuda:
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda.synchronize()

    with profile(activities=activities) as prof:
        mark()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        mark()
    return out, reduce(prof.profiler.kineto_results.events(), host_s)


def reduce(events, host_s: float) -> Trace:
    """Reduce the profiler's raw events (``kineto_results.events()``)."""
    from torch.autograd import DeviceType

    marks, dev, cpu, launch = [], [], [], {}
    for ev in events:
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or name.startswith(PREFIX):
                continue
            (marks if "spin_kernel" in name else dev).append((start, end, name,
                                                              ev.correlation_id()))
        else:
            cpu.append((start, end, name, ev.start_thread_id()))
            if name.startswith("cu") and ev.correlation_id():
                launch[ev.correlation_id()] = (start, ev.start_thread_id())
    marks.sort()
    if len(marks) >= 2:
        lo, hi = marks[0][1], marks[-1][0]
    elif dev:
        lo, hi = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        lo = hi = 0
    device_ops: dict = {}
    for start, end, name, _ in dev:
        device_ops[_short(name)] = device_ops.get(_short(name), 0.0) + (end - start) * 1e-9
    merged: list = []
    for start, end, _, _ in sorted(dev):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    range_s, range_calls, range_host_s, range_wait_s = _ranges(dev, cpu, launch)
    return Trace(window_s=(hi - lo) * 1e-9, busy_s=sum(e - s for s, e in merged) * 1e-9,
                 host_s=host_s, device_ops=device_ops, range_s=range_s,
                 range_calls=range_calls, range_host_s=range_host_s,
                 range_wait_s=range_wait_s, idle_gaps=_name_gaps(gaps, cpu))


def _inside(ivs, t, th):
    """Which of the instants ``t`` on threads ``th`` lie inside one of the
    intervals ``ivs`` (``(start, end, thread)``, not nested), and its end."""
    ivs = sorted(ivs)
    st = np.array([iv[0] for iv in ivs], dtype=np.int64)
    en = np.array([iv[1] for iv in ivs], dtype=np.int64)
    tid = np.array([iv[2] for iv in ivs], dtype=np.int64)
    k = np.searchsorted(st, t, side="right") - 1
    kk = np.where(k >= 0, k, 0)
    return (k >= 0) & (t <= en[kk]) & (th == tid[kk]), en[kk]


def _ranges(dev, cpu, launch):
    """Device seconds, calls, host seconds and host seconds waiting of each
    harness range; a kernel belongs to a range by its launch's time."""
    by_name: dict = {}
    for start, end, name, thread in cpu:
        if name.startswith(PREFIX):
            by_name.setdefault(name, []).append((start, end, thread))
    launched = [(launch[c][0], launch[c][1], end - start) for start, end, _, c in dev
                if c in launch]
    t = np.array([x[0] for x in launched], dtype=np.int64)
    th = np.array([x[1] for x in launched], dtype=np.int64)
    dur = np.array([x[2] for x in launched], dtype=np.float64)
    waits = [(s, e, thread) for s, e, name, thread in cpu
             if name == STALL or (name.startswith("cu") and any(w in name for w in WAITS))]
    ws = np.array([w[0] for w in waits], dtype=np.int64)
    we = np.array([w[1] for w in waits], dtype=np.int64)
    wth = np.array([w[2] for w in waits], dtype=np.int64)
    range_s, calls, host, wait = {}, {}, {}, {}
    for name, ivs in by_name.items():
        inside, _ = _inside(ivs, t, th)
        range_s[name] = float(dur[inside].sum()) * 1e-9
        calls[name] = len(ivs)
        host[name] = sum(e - s for s, e, _ in ivs) * 1e-9
        inside, end = _inside(ivs, ws, wth)
        wait[name] = float((np.minimum(we, end) - ws)[inside].sum()) * 1e-9
    return range_s, calls, host, wait


def _name_gaps(gaps, cpu) -> dict:
    """Idle seconds by ``"<harness range> > <innermost host op>"`` open at
    each gap's middle, over the longest gaps (the rest as ``other gaps``)."""
    if not gaps:
        return {}
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    named, rest = gaps[:_GAPS_NAMED], gaps[_GAPS_NAMED:]
    cs = np.array([c[0] for c in cpu], dtype=np.int64)
    ce = np.array([c[1] for c in cpu], dtype=np.int64)
    is_range = np.array([c[2].startswith(PREFIX) for c in cpu], dtype=bool)
    out: dict = {}
    for s, e in named:
        mid = (s + e) // 2
        open_ = np.nonzero((cs <= mid) & (ce >= mid))[0]
        ops = [i for i in open_ if not is_range[i]]
        ranges = [i for i in open_ if is_range[i]]
        inner = cpu[min(ops, key=lambda i: ce[i] - cs[i])][2] if ops else "no host op"
        outer = cpu[min(ranges, key=lambda i: ce[i] - cs[i])][2] if ranges else "outside ranges"
        key = _short(f"{outer} > {inner}")
        out[key] = out.get(key, 0.0) + (e - s) * 1e-9
    if rest:
        out["other gaps"] = sum(e - s for s, e in rest) * 1e-9
    return out
