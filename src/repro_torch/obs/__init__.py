"""repro_torch.obs — metrics and tracing for serving and training.

Three pieces, off by default, as in the JAX package's ``obs``:

* ``MetricsRegistry`` (``registry``) — labeled ``Counter`` / ``Gauge`` /
  ``Histogram`` with snapshot/JSONL sinks and multi-engine merge (stdlib
  only);
* ``Tracer`` (``trace``) — ``span()`` context managers and caller-timed
  ``complete()`` events exporting Chrome-trace/Perfetto JSON, with
  optional ``torch.profiler.record_function`` ranges; the module-level
  ``span`` marks the program's layer boundaries and records into the
  tracer that ``Tracer.active()`` made active on the calling thread;
* ``CollisionTelemetry`` (``collision``) — measured collision mass over
  served ids, the planner's predicted-vs-observed feedback signal.

``Obs`` bundles one of each — the single handle ``RecsysEngine`` and
``Trainer`` accept (``obs=None`` everywhere means every instrumentation
branch is skipped: the off-by-default contract).
"""

from __future__ import annotations

from typing import Optional, Sequence

from .collision import CollisionTelemetry, predicted_collision_mass
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "CollisionTelemetry", "predicted_collision_mass", "Obs",
]


class Obs:
    """One observability bundle: registry + tracer (+ collision
    telemetry once an engine attaches table sizes).

    ``Obs(trace=True)`` turns span recording on; ``Obs(collisions=True)``
    asks the serving engine to accumulate served-id histograms (the
    engine calls ``attach_collisions(table_sizes)`` when it boots);
    ``profiler_annotations=True`` mirrors spans, and each served wave, into
    ``torch.profiler`` ranges.  ``Trainer.run`` makes the tracer active, so
    a traced training run records the program's own ``repro.*`` spans too.
    """

    def __init__(self, *, trace: bool = False, collisions: bool = False,
                 profiler_annotations: bool = False):
        self.registry = MetricsRegistry()
        self.tracer: Optional[Tracer] = (
            Tracer(profiler_annotations=profiler_annotations) if trace else None)
        self.want_collisions = collisions
        self.collisions: Optional[CollisionTelemetry] = None

    def attach_collisions(self, table_sizes: Sequence[int],
                          compact_every: int = 64) -> None:
        if self.want_collisions and self.collisions is None:
            self.collisions = CollisionTelemetry(
                table_sizes, compact_every=compact_every)

    # thin pass-throughs so call sites read ``obs.counter(...)``
    def counter(self, name: str, help: str = "") -> Counter:
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: Optional[int] = 65536) -> Histogram:
        return self.registry.histogram(name, help, max_samples=max_samples)

    def save(self, metrics_path: Optional[str] = None,
             trace_path: Optional[str] = None) -> None:
        if metrics_path:
            self.registry.save_jsonl(metrics_path)
        if trace_path and self.tracer is not None:
            self.tracer.save(trace_path)
