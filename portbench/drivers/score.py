"""Traffic kind ``score``: a ranking client scoring blocks of candidates.

The loop is closed, with ``inflight`` requests in flight: the client
issues its next ``predict`` call before it reads the scores of the
``inflight - 1`` before it, so the card has that much work queued while
the host stands still.  When the window's time is up the client sends
nothing more, waits for every request it sent, and only then reads the
clock: all of that work counts, over all of that time.  A request is one
``predict`` call over N candidates, each with the stream's dense features
and one id per table; its latency runs from the call to its scores in the
client's (pinned) host buffer, the wait behind the requests ahead of it
included.

Set-up makes everything from the seed on the device: the f32 parameters,
the program's served tables (``quantize_params`` in the traffic's
``quantize`` mode), and a pool of ``pool`` requests, cycled in the window.
The sizes and their order are the same for every seed (``request_sizes``);
the candidates are one draw of the frozen stream from the seed, cut into
the requests.  Each request is served
once before the window, so every shape is warm.

``correct``: once the window has closed and the program's state is freed,
the last scores the client received for every request served in the
window are compared with the plain reference, which quantises the same
f32 tables itself.  The number is the widest gap of a score from the
reference's, over the largest reference score in magnitude.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time

import torch

from portbench.lib import params as P
from portbench.lib import precision, stream, trace
from portbench.lib.ranges import maybe as _range
from portbench.lib.stages import Stages
from portbench.reference import embed as ref_embed

REQUEST, WAIT = "portbench.request", "portbench.wait"


def request_sizes(traffic: dict) -> list:
    """The pool's candidate counts, the same for every seed: ``pool``
    log-uniform quantiles of ``[min, max]``, in the fixed order of a
    stride near ``0.618 · pool`` coprime with it (small and large requests
    interleave; which follow which does not move with the seed)."""
    n, lo, hi = traffic["pool"], traffic["candidates"]["min"], traffic["candidates"]["max"]
    sizes = [round(lo * (hi / lo) ** ((k + 0.5) / n)) for k in range(n)]
    stride = max(1, round(0.618 * n))
    while math.gcd(stride, n) != 1:
        stride += 1
    return [sizes[(i * stride) % n] for i in range(n)]


def reference_tables(params, mode: str):
    """The reference's own served tables from the f32 ones."""
    if mode == "f32":
        return params["tables"]
    if mode != "int8":
        raise ValueError(f"quantize mode {mode!r}")
    return [{k: ref_embed.quantize_rows(w) for k, w in t.items()} for t in params["tables"]]


class Bench:
    def __init__(self, cell, seed: int, device="cuda", fault: str | None = None,
                 control: bool = False):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.conf, self.traffic, self.model = cell.conf, cell.traffic, cell.model
        self.fault, self.control = fault, control
        self.inflight = self.traffic["inflight"]

    # ---------------------------------------------------------------- set-up
    def _params(self):
        return P.make(self.model.layout(self.conf), self.seed, self.device)

    def setup(self) -> None:
        clock = Stages()
        precision.state(self.conf)
        sizes = request_sizes(self.traffic)
        s = self.traffic["stream"]
        spec = stream.CriteoSpec(table_sizes=tuple(self.conf["table_sizes"]),
                                 dense_dim=self.conf["dense_dim"], zipf=s["zipf"],
                                 noise=s["noise"])
        draw = stream.batch_at(self.seed, 0, sum(sizes), spec, self.device)
        self.pool = [{"dense": d, "sparse": x} for d, x in
                     zip(torch.split(draw["dense"], sizes), torch.split(draw["sparse"], sizes))]
        del draw
        clock("pool")
        host = torch.empty(sum(sizes), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        self.host = list(torch.split(host, sizes))
        clock("pinned host buffers")
        params = self._params()
        self.fingerprint = P.fingerprint(params)
        clock("parameters")
        self.predict, self.served = self._program(params)
        del params
        clock("program")
        self.order = list(range(len(self.pool)))
        self._loop(self.order, None, None)          # warm: every shape once
        clock("warm-up")
        self.stages = clock.seconds

    def _program(self, params):
        """The scoring call and the tables it serves: the port's, or with
        ``control`` the reference's in TF32."""
        mode = self.traffic["quantize"]
        if self.control:
            served = dict(params, tables=reference_tables(params, mode))
            self.ranges = contextlib.nullcontext

            def predict(p, batch):
                with precision.tf32():
                    return self.model.reference_forward(p, batch["dense"], batch["sparse"],
                                                        self.conf, tables=p["tables"])
            return predict, served
        from repro_torch.serve.quantize import quantize_params
        port = self.model.port(self.conf, self.device)
        self.ranges = port.ranges
        return _faulty(port.predict, self.fault), quantize_params(params, mode)

    # ---------------------------------------------------------------- window
    def _issue(self, k: int, dispatch):
        batch = self.pool[k]
        t0 = time.perf_counter()
        with torch.no_grad():
            out = self.predict(self.served, batch)
        if dispatch is not None:
            dispatch.append(time.perf_counter() - t0)
        self.host[k].copy_(out, non_blocking=True)
        done = torch.cuda.Event() if self.device.type == "cuda" else None
        if done is not None:
            done.record()
        return k, t0, done

    def _reap(self, item, latencies):
        k, t0, done = item
        if done is not None:
            done.synchronize()
        if latencies is not None:
            latencies.append(time.perf_counter() - t0)
        return k

    def _loop(self, order, latencies, dispatch, until=None, ranged=False):
        """Serve ``order`` (cycled while ``until`` is a future clock
        reading, else once); returns the requests served, in order."""
        pending, served, i = collections.deque(), [], 0
        while (i < len(order)) if until is None else (time.perf_counter() < until):
            with _range(ranged, REQUEST):
                pending.append(self._issue(order[i % len(order)], dispatch))
            i += 1
            if len(pending) >= self.inflight:
                with _range(ranged, WAIT):
                    served.append(self._reap(pending.popleft(), latencies))
        while pending:
            with _range(ranged, WAIT):
                served.append(self._reap(pending.popleft(), latencies))
        return served

    def window(self, seconds: float) -> dict:
        latencies, dispatch = [], []
        t0 = time.perf_counter()
        served = self._loop(self.order, latencies, dispatch, until=t0 + seconds)
        wall = time.perf_counter() - t0
        self.in_window = sorted(set(served))
        samples = sum(self.pool[k]["dense"].shape[0] for k in served)
        latencies.sort()
        p99 = latencies[min(len(latencies) - 1, int(0.99 * len(latencies)))]
        self.notes = {"dispatch_ms_median": 1e3 * sorted(dispatch)[len(dispatch) // 2],
                      "latency_ms_median": 1e3 * latencies[len(latencies) // 2]}
        return {"attempted": len(served), "failed": 0, "wall_s": wall, "samples": samples,
                "metrics": {"samples_per_s": samples / wall, "p99_ms": p99 * 1e3},
                "dispatch_s": dispatch}

    def traced(self):
        """One cycle of the pool under the profiler, with the harness's
        ranges."""
        with self.ranges():
            served, tr = trace.capture(
                lambda: self._loop(self.order, None, None, ranged=True), self.device)
        return tr, {"requests": served}

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        del self.predict, self.served

    def check(self) -> dict:
        params = self._params()
        if P.fingerprint(params) != self.fingerprint:
            raise RuntimeError("the parameters made again from the seed differ from set-up's")
        tables = reference_tables(params, self.traffic["quantize"])
        gap = top = 0.0
        with torch.no_grad():
            for k in self.in_window:
                batch = self.pool[k]
                want = self.model.reference_forward(params, batch["dense"], batch["sparse"],
                                                    self.conf, tables=tables).cpu()
                got = self.host[k]
                if not bool(torch.isfinite(got).all()):
                    return {"score_gap": float("inf")}
                gap = max(gap, float((got - want).abs().max()))
                top = max(top, float(want.abs().max()))
        return {"score_gap": gap / top}


def _faulty(predict, fault):
    """``predict`` with a planted fault, for the check's own tests and
    readings: ``altered`` changes one score of every answer; ``half``
    scores the first half of the candidates and repeats it."""
    if fault is None:
        return predict
    if fault == "altered":
        def altered(p, batch):
            out = predict(p, batch)
            out[0] += 1.0
            return out
        return altered
    if fault == "half":
        def half(p, batch):
            n = batch["dense"].shape[0]
            part = predict(p, {k: v[:(n + 1) // 2] for k, v in batch.items()})
            return torch.cat([part, part])[:n]
        return half
    raise ValueError(f"score has no fault {fault!r}")
