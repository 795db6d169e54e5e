"""Zero-dependency metrics registry: counters, gauges, histograms.

The port's copy of the JAX package's ``obs.registry`` (stdlib only, the
same semantics and sink formats, so a metrics file written by either
package reads in the other).  The serving and training layers fold their
stats into one registry:

* ``Counter`` — monotone accumulator (``inc``); merge = sum;
* ``Gauge``   — last-written value (``set``); merge = other wins;
* ``Histogram`` — raw-sample distribution (``observe``) with
  numpy-compatible linear-interpolation percentiles; merge = sample
  union.  Samples are kept raw (bounded by ``max_samples``, oldest
  dropped first) so percentile math is exact, not bucket-approximate —
  the obs tests pin ``percentile(q) == np.percentile(samples, q)``.

Every metric is labeled: ``hist.labels(stage="dense").observe(dt)``
binds a label set to a series once and returns a handle with zero
per-call dict hashing — the pattern the serving hot path uses so obs-on
stays within the 2% QPS overhead budget.  All mutation goes through one
``threading.Lock`` per registry (engines may reap on one thread while a
metrics scrape runs on another).

Sinks: ``snapshot()`` (plain nested dict), ``to_jsonl()`` /
``save_jsonl(path)`` (one JSON object per series — the CI artifact
format), ``merge(other)`` (fold another registry in, e.g. per-engine
registries of a multi-engine bench), ``reset(prefix=)`` (drop series —
what ``RecsysEngine.reset_metrics`` calls so warm-up traffic never
leaks into steady-state numbers).

Stdlib-only on purpose: importing ``repro_torch.obs.registry`` pulls no
torch or numpy into a process that only wants to read a metrics file.
"""

from __future__ import annotations

import json
import threading
from typing import Iterable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _percentile(sorted_samples: list[float], q: float) -> float:
    """numpy's default ('linear') percentile on pre-sorted samples."""
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("percentile of an empty series")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q={q} outside [0, 100]")
    rank = (n - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_samples[lo] * (1.0 - frac) + sorted_samples[hi] * frac


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Series:
    """One (metric, labelset) time-series; subclasses hold the value."""

    def __init__(self, metric: "_Metric", labels: dict):
        self._metric = metric
        self._lock = metric._lock
        self.labels_dict = dict(labels)


class _CounterSeries(_Series):
    def __init__(self, metric, labels):
        super().__init__(metric, labels)
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter increment must be >= 0, got {value}")
        with self._lock:
            self.value += value


class _GaugeSeries(_Series):
    def __init__(self, metric, labels):
        super().__init__(metric, labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self.value += value


class _HistogramSeries(_Series):
    def __init__(self, metric, labels, max_samples: Optional[int]):
        super().__init__(metric, labels)
        self.max_samples = max_samples
        self.samples: list[float] = []
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            self.samples.append(float(value))
            if self.max_samples is not None \
                    and len(self.samples) > self.max_samples:
                del self.samples[0]

    def percentile(self, q: float) -> float:
        with self._lock:
            return _percentile(sorted(self.samples), q)

    def summary(self) -> dict:
        with self._lock:
            s = sorted(self.samples)
        out = {"count": self.count, "sum": self.sum}
        if s:
            out.update(min=s[0], max=s[-1],
                       p50=_percentile(s, 50), p99=_percentile(s, 99))
        return out


class _Metric:
    series_cls = _Series

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: dict[tuple, _Series] = {}

    def _make_series(self, labels: dict) -> _Series:
        return self.series_cls(self, labels)

    def labels(self, **labels) -> _Series:
        """Bind a label set -> its series (created on first use).  Hold
        the returned handle on hot paths: repeated calls re-hash."""
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._make_series(labels)
                self._series[key] = s
            return s

    def series(self) -> list[_Series]:
        with self._lock:
            return list(self._series.values())


class Counter(_Metric):
    series_cls = _CounterSeries
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(value)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class Gauge(_Metric):
    series_cls = _GaugeSeries
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, lock, max_samples: Optional[int] = 65536):
        super().__init__(name, help, lock)
        self.max_samples = max_samples

    def _make_series(self, labels):
        return _HistogramSeries(self, labels, self.max_samples)

    def observe(self, value: float, **labels) -> None:
        self.labels(**labels).observe(value)

    def percentile(self, q: float, **labels) -> float:
        return self.labels(**labels).percentile(q)


class MetricsRegistry:
    """Name -> metric map with get-or-create constructors.

    Re-requesting a name returns the same object; re-requesting it as a
    *different* type raises (two subsystems silently sharing one name
    with different semantics is the bug registries exist to prevent).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, name: str, cls, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: Optional[int] = 65536) -> Histogram:
        return self._get(name, Histogram, help, max_samples=max_samples)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # ------------------------------------------------------------- sinks

    def snapshot(self) -> dict:
        """Plain nested dict of every series — JSON-safe, no live refs."""
        out: dict = {}
        for m in self.metrics():
            series = []
            for s in m.series():
                entry: dict = {"labels": dict(s.labels_dict)}
                if isinstance(s, _HistogramSeries):
                    entry.update(s.summary())
                else:
                    entry["value"] = s.value
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def to_jsonl(self) -> str:
        """One JSON object per series (the CI artifact format)."""
        lines = []
        snap = self.snapshot()
        for name in sorted(snap):
            meta = snap[name]
            for s in meta["series"]:
                rec = {"name": name, "type": meta["type"], **s}
                lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    def save_jsonl(self, path: str) -> str:
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    # ------------------------------------------------------------- merge

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry: counters sum, gauges take
        the other's value (last writer wins), histograms union samples.
        Multi-engine runs keep one registry per engine and merge for the
        report, so per-engine resets never race a shared scrape."""
        for om in other.metrics():
            if isinstance(om, Counter):
                mine = self.counter(om.name, om.help)
                for s in om.series():
                    mine.labels(**s.labels_dict).inc(s.value)
            elif isinstance(om, Gauge):
                mine = self.gauge(om.name, om.help)
                for s in om.series():
                    mine.labels(**s.labels_dict).set(s.value)
            elif isinstance(om, Histogram):
                mine = self.histogram(om.name, om.help,
                                      max_samples=om.max_samples)
                for s in om.series():
                    dst = mine.labels(**s.labels_dict)
                    with self._lock:
                        dst.samples.extend(s.samples)
                        dst.count += s.count
                        dst.sum += s.sum
                        if dst.max_samples is not None:
                            excess = len(dst.samples) - dst.max_samples
                            if excess > 0:
                                del dst.samples[:excess]

    def reset(self, prefix: Optional[str] = None,
              names: Optional[Iterable[str]] = None) -> None:
        """Drop series: everything, a name ``prefix``, or explicit
        ``names``.  Metric objects stay registered (held handles keep
        working) — only their series are cleared."""
        sel = set(names) if names is not None else None
        for m in self.metrics():
            if prefix is not None and not m.name.startswith(prefix):
                continue
            if sel is not None and m.name not in sel:
                continue
            with self._lock:
                for s in m._series.values():
                    if isinstance(s, _HistogramSeries):
                        s.samples.clear()
                        s.count = 0
                        s.sum = 0.0
                    else:
                        s.value = 0.0
