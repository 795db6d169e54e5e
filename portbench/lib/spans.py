"""The program's own spans in the traced stretch: the ``repro.*`` ranges
that ``repro_torch.obs.trace.span`` opens in ``torch.profiler`` while a
tracer with profiler annotations is active.

The spans are opt-in: ``install()`` wraps two functions of ``trace`` for
the rest of the process (``uninstall()`` puts them back), leaving every
field of its ``Trace`` as it was.  The reader of each metric that reads
the spans calls it when the harness loads the reader, that is for a cell
whose per-layer metrics in ``BENCHMARK.json`` name such a metric;
importing this module alone changes nothing.

  * ``trace.capture`` runs the stretch with such a tracer of the program
    active on its thread; a program without ``span`` runs as before, and
    the readers then find nothing to read;
  * ``trace.reduce`` keeps the raw events on the ``Trace`` it returns
    (``events``), which ``of(trace)`` reduces on a reader's first call.

For each span name, ``reduce`` gives:

  * ``calls``, ``host_s`` and ``wait_s``: the span's calls, its host
    seconds, and the part of them its thread spent waiting for the device,
    as ``trace`` computes them for the harness's ranges;
  * ``launched``: the device events whose launch lies inside the span on
    its thread;
  * ``backward``: the device events launched by the backward of the
    forward ops that began inside the span on its thread.  A backward op
    (``autograd::engine::evaluate_function: …``, on whatever thread
    autograd runs it: the backward of CUDA tensors runs on a thread of its
    own)
    carries its forward op's ``sequence_nr`` and thread
    (``fwd_thread_id``); its launches lie inside it on its own thread.  Of
    the forward ops that record one sequence number on one thread (an op
    that makes no autograd node records the next node's number), the last
    to start made the node.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from portbench.lib import trace

PREFIX = "repro."
EVALUATE = "autograd::engine::evaluate_function: "
FORWARD, BACKWARD = "repro.train.forward", "repro.train.backward"
EMBED, MLP, LAUNCH = "repro.embed", "repro.mlp", "repro.launch"


@dataclasses.dataclass
class Spans:
    calls: dict
    host_s: dict
    wait_s: dict
    dur_s: np.ndarray          # seconds of each device event with a known launch
    launched: dict             # span name -> mask over ``dur_s``
    backward: dict             # span name -> mask over ``dur_s``

    def device_s(self, launched=(), backward=()) -> float:
        """Device seconds of the events launched inside a span named in
        ``launched`` or by the backward of one named in ``backward``, each
        event once."""
        mask = np.zeros(len(self.dur_s), dtype=bool)
        for name in launched:
            mask |= self.launched.get(name, False)
        for name in backward:
            mask |= self.backward.get(name, False)
        return float(self.dur_s[mask].sum())


def of(tr) -> Spans | None:
    """The program's spans in the traced stretch ``tr`` (a ``trace.Trace``),
    or None where it holds none: no trace, or a program without spans."""
    if tr is None or getattr(tr, "events", None) is None:
        return None
    if getattr(tr, "spans", None) is None:
        tr.spans = reduce(tr.events)
    return tr.spans if tr.spans.calls else None


def ms_per_step(tr, launched=(), backward=()):
    """``device_s(launched, backward)`` in ms per training step (a call of
    ``repro.train.forward``) of the traced stretch ``tr``, or None where
    it holds no such step or no such device time."""
    sp = of(tr)
    steps = sp and sp.calls.get(FORWARD)
    spent = steps and sp.device_s(launched, backward)
    return spent / steps * 1e3 if spent else None


def _within(ivs, t, th):
    """Which instants ``t`` on threads ``th`` lie inside one of the
    intervals ``ivs`` (``(start, end, thread)``, nested or overlapping) on
    their own thread, and the end of the merged interval that holds each:
    ``trace._inside`` over each thread's merged intervals."""
    inside = np.zeros(len(t), dtype=bool)
    end = np.zeros(len(t), dtype=np.int64)
    for thread in {iv[2] for iv in ivs}:
        merged: list = []
        for s, e in sorted((s, e) for s, e, x in ivs if x == thread):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        hit, until = trace._inside([(s, e, thread) for s, e in merged], t, th)
        inside |= hit
        end = np.where(hit, until, end)
    return inside, end


def reduce(events) -> Spans:
    """Reduce the profiler's raw events (``kineto_results.events()``)."""
    from torch.autograd import DeviceType

    dev, launch, spans, waits, forward, backward = [], {}, {}, [], {}, []
    for ev in events:
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not (ev.is_user_annotation() or name.startswith((trace.PREFIX, PREFIX))
                    or "spin_kernel" in name):
                dev.append((end - start, ev.correlation_id()))
            continue
        thread = ev.start_thread_id()
        if name == trace.STALL or (name.startswith("cu")
                                   and any(w in name for w in trace.WAITS)):
            waits.append((start, end, thread))
        if name.startswith("cu"):
            if ev.correlation_id():
                launch[ev.correlation_id()] = (start, thread)
        elif name.startswith(PREFIX):
            spans.setdefault(name, []).append((start, end, thread))
        elif name.startswith(EVALUATE):
            if ev.sequence_nr() >= 0 and ev.fwd_thread_id():
                backward.append((start, end, thread, (ev.fwd_thread_id(), ev.sequence_nr())))
        elif ev.sequence_nr() >= 0 and not ev.fwd_thread_id():
            key = (thread, ev.sequence_nr())
            forward[key] = max(forward.get(key, start), start)

    known = [(launch[c], d) for d, c in dev if c in launch]
    t = np.array([x[0][0] for x in known], dtype=np.int64)
    th = np.array([x[0][1] for x in known], dtype=np.int64)
    dur = np.array([x[1] for x in known], dtype=np.float64) * 1e-9
    ws = np.array([w[0] for w in waits], dtype=np.int64)
    we = np.array([w[1] for w in waits], dtype=np.int64)
    wth = np.array([w[2] for w in waits], dtype=np.int64)

    made = [forward.get(key) for _, _, _, key in backward]
    ft = np.array([-1 if m is None else m for m in made], dtype=np.int64)
    fth = np.array([key[0] for _, _, _, key in backward], dtype=np.int64)

    calls, host, wait, launched, by_backward = {}, {}, {}, {}, {}
    for name, ivs in spans.items():
        calls[name] = len(ivs)
        host[name] = sum(e - s for s, e, _ in ivs) * 1e-9
        inside, end = _within(ivs, ws, wth)
        wait[name] = float((np.minimum(we, end) - ws)[inside].sum()) * 1e-9
        launched[name] = _within(ivs, t, th)[0]
        of_span = _within(ivs, ft, fth)[0] & (ft >= 0)
        ops = [b[:3] for b, hit in zip(backward, of_span) if hit]
        by_backward[name] = _within(ops, t, th)[0]
    return Spans(calls=calls, host_s=host, wait_s=wait, dur_s=dur, launched=launched,
                 backward=by_backward)


def _program_spans():
    """A tracer of the program, active with profiler annotations on, or a
    null context for a program that has no ``span``."""
    from repro_torch.obs import trace as program
    if not hasattr(program, "span"):
        return contextlib.nullcontext()
    return program.Tracer(profiler_annotations=True).active()


_plain: tuple = ()          # trace's own (capture, reduce) while installed


def install() -> None:
    """Run every later traced stretch of this process with the program's
    spans on, and keep its raw events; a second call changes nothing."""
    global _plain
    if _plain:
        return
    _plain = capture, reduce_ = trace.capture, trace.reduce

    def capture_with_spans(fn, device):
        with _program_spans():
            return capture(fn, device)

    def reduce_keeping_events(events, host_s: float):
        events = list(events)
        tr = reduce_(events, host_s)
        tr.events = events
        return tr

    trace.capture, trace.reduce = capture_with_spans, reduce_keeping_events


def uninstall() -> None:
    """Put ``trace``'s own functions back."""
    global _plain
    if _plain:
        trace.capture, trace.reduce = _plain
        _plain = ()
