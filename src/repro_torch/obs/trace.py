"""Span tracer with Chrome-trace / Perfetto JSON export.

``Tracer`` records *complete* events (name, begin, duration) on a
monotonic clock, either through the ``span("stage")`` context manager
(nesting tracked per thread) or through ``complete(name, t0, dur)`` when
the caller already owns the boundary timestamps (the serving engine's
usage: its stage timers double as the trace events, so tracing adds zero
extra clock reads).

The program marks its own layer boundaries with the module-level
``span(name, **args)``: the train step's forward, backward and optimizer
(``repro.train.*``), the models' embed stage, MLPs and interaction
(``repro.embed``, ``repro.mlp``, ``repro.interact``) and the kernel
launchers (``repro.launch``).  Off by default, ``span`` hands back one
shared null context: no clock read, no profiler range (its arguments are
still evaluated by the caller).  Inside ``with tracer.active():`` every
such span opened on that thread records into ``tracer`` (``Trainer.run``
turns on the tracer of the ``Obs`` it was given); each thread has its
own active tracer, so spans of other threads (autograd's device thread
among them) record nothing.

Export is the Chrome Trace Event JSON format (``{"traceEvents": [...]}``
with ``ph: "X"`` complete events, microsecond timestamps from the
tracer's creation), which ``chrome://tracing`` and
https://ui.perfetto.dev both load directly — one wave renders as a
``wave`` bar with its stage bars nested inside.  The event layout is the
JAX package's, so the same caller-timed events export to the same JSON in
both packages.  ``otherData.origin_unix_ns`` places the events on the
clock ``torch.profiler`` stamps its own with (``time.time_ns()``, taken
with the tracer's origin): an event's ``ts`` in µs, times 1,000, plus the
origin is its start in the profiler's nanoseconds.

``profiler_annotations=True`` makes each ``span`` also enter a
``torch.profiler.record_function`` range of the same name, so when a run
is wrapped in ``torch.profiler.profile`` the program's stages line up
against the device's own timeline (the serving engine opens one ``wave``
range per wave through ``range_begin`` / ``range_end``).

The tracer is append-only and bounded (``max_events``, oldest dropped);
``drain()`` hands the events over and clears, so a long-running engine
can stream trace chunks without unbounded growth.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

__all__ = ["Tracer", "span"]

_NULL = contextlib.nullcontext()
_active = threading.local()     # ``.tracer``: what ``span`` records into on this thread


def span(name: str, **args):
    """A span at one of the program's layer boundaries: this thread's
    active tracer's ``span(name, **args)``, or with no tracer active one
    shared null context."""
    tracer = getattr(_active, "tracer", None)
    return _NULL if tracer is None else tracer.span(name, **args)


class Tracer:
    def __init__(self, *, profiler_annotations: bool = False, max_events: int = 200_000,
                 pid: int = 0):
        self.max_events = max_events
        self.pid = pid
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.monotonic()
        self._origin_unix_ns = time.time_ns()
        self._annotate = None
        if profiler_annotations:
            from torch.profiler import record_function
            self._annotate = record_function

    @contextlib.contextmanager
    def active(self):
        """Record the program's ``span``s of this thread into this tracer
        for the block (the thread's tracer active before is restored
        after)."""
        before = getattr(_active, "tracer", None)
        _active.tracer = self
        try:
            yield self
        finally:
            _active.tracer = before

    # ------------------------------------------------------------- recording

    def _now(self) -> float:
        return time.monotonic()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def _append(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)
            if len(self.events) > self.max_events:
                del self.events[0]

    def complete(self, name: str, t0: float, dur_s: float, **args) -> None:
        """Record one complete event from caller-owned monotonic
        timestamps (``t0`` from ``time.monotonic()``, duration in
        seconds).  The hot-path entry point: no clock reads here."""
        ev = {"name": name, "ph": "X", "pid": self.pid,
              "tid": threading.get_ident() & 0xFFFF,
              "ts": (t0 - self._t0) * 1e6, "dur": dur_s * 1e6}
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Context manager form: times the block, tracks nesting depth
        per thread (depth rides in ``args.depth`` so malformed nesting is
        assertable), optionally mirrors into a profiler range."""
        depth = self._depth()
        self._local.depth = depth + 1
        ctx = self._annotate(name) if self._annotate is not None else None
        if ctx is not None:
            ctx.__enter__()
        t0 = self._now()
        try:
            yield self
        finally:
            dur = self._now() - t0
            if ctx is not None:
                ctx.__exit__(None, None, None)
            self._local.depth = depth
            self.complete(name, t0, dur, depth=depth, **args)

    def range_begin(self, name: str):
        """Open a profiler range ``name`` that the caller closes with
        ``range_end``, for an interval no ``with`` block can hold (a served
        wave opens at dispatch and closes at reap); None when profiler
        annotations are off."""
        if self._annotate is None:
            return None
        ctx = self._annotate(name)
        ctx.__enter__()
        return ctx

    @staticmethod
    def range_end(ctx) -> None:
        if ctx is not None:
            ctx.__exit__(None, None, None)

    # ------------------------------------------------------------- export

    def chrome_trace(self) -> dict:
        """The Chrome Trace Event payload (Perfetto-loadable)."""
        with self._lock:
            events = [dict(e) for e in self.events]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"origin_unix_ns": self._origin_unix_ns}}

    def to_json(self) -> str:
        return json.dumps(self.chrome_trace())

    def save(self, path: str) -> str:
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def drain(self) -> list[dict]:
        """Hand over and clear the event buffer (streaming export)."""
        with self._lock:
            events, self.events = self.events, []
        return events

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)
