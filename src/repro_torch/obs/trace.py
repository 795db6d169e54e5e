"""Span tracer with Chrome-trace / Perfetto JSON export.

``Tracer`` records *complete* events (name, begin, duration) on a
monotonic clock, either through the ``span("stage")`` context manager
(nesting tracked per thread — the train loop's usage) or through
``complete(name, t0, dur)`` when the caller already owns the boundary
timestamps (the serving engine's usage: its stage timers double as the
trace events, so tracing adds zero extra clock reads).

Export is the Chrome Trace Event JSON format (``{"traceEvents": [...]}``
with ``ph: "X"`` complete events, microsecond timestamps), which
``chrome://tracing`` and https://ui.perfetto.dev both load directly —
one wave renders as a ``wave`` bar with its stage bars nested inside.
The event layout is the JAX package's, so the same caller-timed events
export to the same JSON in both packages.

Two honesty knobs:

* ``fence=True`` — ``tracer.fence(x)`` synchronizes the CUDA device that
  holds ``x`` (``torch.cuda.synchronize``) before the enclosing span
  closes, so a span around asynchronous launches measures *device* time,
  not launch time.  Off by default: fencing serializes the pipeline and
  is a measurement mode, never a serving mode (with ``fence=False``, or
  for tensors on the CPU, ``fence(x)`` is a passthrough).
* ``profiler_annotations=True`` — each ``span`` additionally enters a
  ``torch.profiler.record_function`` range of the same name, so when a run
  is wrapped in ``torch.profiler.profile`` the engine's logical stages
  line up against the device's own timeline (the serving engine opens one
  ``wave`` range per wave through ``range_begin`` / ``range_end``).

The tracer is append-only and bounded (``max_events``, oldest dropped);
``drain()`` hands the events over and clears, so a long-running engine
can stream trace chunks without unbounded growth.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

__all__ = ["Tracer"]


class Tracer:
    def __init__(self, *, fence: bool = False, profiler_annotations: bool = False,
                 max_events: int = 200_000, pid: int = 0):
        self.fence_enabled = fence
        self.max_events = max_events
        self.pid = pid
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0 = time.monotonic()
        self._annotate = None
        if profiler_annotations:
            from torch.profiler import record_function
            self._annotate = record_function

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

    def instant(self, name: str, **args) -> None:
        ev = {"name": name, "ph": "i", "pid": self.pid,
              "tid": threading.get_ident() & 0xFFFF,
              "ts": (self._now() - self._t0) * 1e6, "s": "t"}
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

    def fence(self, value):
        """Wait for the CUDA device that holds ``value`` (a tensor or a
        tree of them) when fencing is enabled, so the enclosing span
        measures device completion, not asynchronous launch.  Passthrough
        when disabled or when nothing in ``value`` lies on a CUDA device."""
        if self.fence_enabled and value is not None:
            from ..tree import leaves
            for leaf in leaves(value):
                if getattr(leaf, "is_cuda", False):
                    import torch
                    torch.cuda.synchronize(leaf.device)
                    break
        return value

    # ------------------------------------------------------------- export

    def chrome_trace(self) -> dict:
        """The Chrome Trace Event payload (Perfetto-loadable)."""
        with self._lock:
            events = [dict(e) for e in self.events]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

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
