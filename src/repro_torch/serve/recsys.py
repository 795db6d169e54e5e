"""Continuous-batching recsys inference engine over quantized tables.

Each request is *one* scoring call carrying 13 dense floats plus a
variable-length multi-hot id bag per categorical feature.  The engine:

* **queues** requests and forms waves by **continuous batching**
  (``batching="continuous"``, the default): the head request anchors the
  wave's bag-length bucket and up to ``max_batch`` same-bucket requests
  from a bounded lookahead window ride along; the head always ships in
  the next wave, so nothing starves.  ``batching="waves"`` takes strict
  FIFO slices;
* **pads + buckets** every wave to a fixed shape — batch and bag length
  each round up to a power of two.  Padded bag slots carry ``mask = 0``
  (they contribute exactly nothing) and padded batch rows are sliced off
  before scores land;
* **pipelines** waves: up to ``max_inflight`` waves ride PyTorch's
  asynchronous launches before the engine waits on the oldest, so host
  wave formation overlaps device execution (continuous mode only);
* runs the **quantized forward** (int8/bf16 tables via ``serve.quantize``;
  the fused serving kernel and the interaction kernel when
  ``cfg.use_kernel``) as an embed stage and a dense stage;
* tracks per-wave dispatch→ready wall time → **p50/p99 latency and QPS**
  via ``metrics()``.

The hot-row cache, sharded serving, memory plans and observability are
not ported yet; their constructor arguments raise when given.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.dlrm import DLRMConfig, dlrm_forward_from_features, embed_features, tables_for

__all__ = ["RecRequest", "RecsysEngine", "BATCHING_MODES"]

BATCHING_MODES = ("continuous", "waves")

# constructor arguments of features still to port -> their ROADMAP item
_NOT_PORTED = {"cache": "11 (serve/cache.py)", "mesh": "16 (dist/)",
               "mesh_devices": "16 (dist/)", "placement": "16 (dist/)",
               "plan": "13 (plan/)", "obs": "14 (obs/)"}


@dataclasses.dataclass
class RecRequest:
    uid: int
    dense: np.ndarray              # (dense_dim,)
    bags: list[list[int]]          # one multi-hot id bag per categorical
    score: Optional[float] = None
    done: bool = False


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class RecsysEngine:
    def __init__(self, cfg, params, *, max_batch: int = 32,
                 cache=None, mesh=None,
                 batching: str = "continuous", max_inflight: int = 2,
                 lookahead: Optional[int] = None,
                 mesh_devices: Optional[int] = None, placement=None,
                 plan=None, obs=None, device="cuda"):
        if batching not in BATCHING_MODES:
            raise ValueError(f"batching={batching!r} not in {BATCHING_MODES}")
        given = {"cache": cache, "mesh": mesh, "mesh_devices": mesh_devices,
                 "placement": placement, "plan": plan, "obs": obs}
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"RecsysEngine({name}=...) is not ported yet "
                    f"(ROADMAP, modules to port: item {_NOT_PORTED[name]})")
        if not isinstance(cfg, DLRMConfig):
            raise TypeError(f"no recsys serving path for config {type(cfg).__name__}")
        if cfg.embedding.kind == "feature":
            raise NotImplementedError(
                "feature-generation mode has no serving path (F varies)")
        self.cfg = cfg
        self.modules = tables_for(cfg)
        self.device = torch.device(device)
        self.params = _to_device(params, self.device)
        self.max_batch = max_batch
        self.batching = batching
        self.max_inflight = max_inflight
        self.lookahead = lookahead or 4 * max_batch
        self._queue: deque[RecRequest] = deque()
        self._inflight: deque[tuple] = deque()
        self._next_uid = 0
        self.completed: dict[int, RecRequest] = {}
        self.wave_latencies_s: list[float] = []
        self.wave_sizes: list[int] = []
        self.buckets_seen: set[tuple[int, int]] = set()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # ------------------------------------------------------------- model

    def _embed_fwd(self, idx, mask):
        feats = embed_features(self.params["tables"], idx, self.cfg,
                               modules=self.modules, mask=mask,
                               proj=self.params.get("proj"))
        return feats if torch.is_tensor(feats) else torch.stack(feats, dim=1)

    def _dense_fwd(self, dense, feats):
        return dlrm_forward_from_features(self.params, dense, feats, self.cfg)

    # ------------------------------------------------------------- intake

    def submit(self, dense, bags: Sequence[Sequence[int]]) -> int:
        """Queue one request.  Bags may be empty (a user with no history for
        that feature): an empty bag pools to the exact zero vector.  Ids are
        checked against each table's size here, on the host: the kernels
        read rows by address and take ids as given."""
        if len(bags) != len(self.modules):
            raise ValueError(f"expected {len(self.modules)} feature bags, "
                             f"got {len(bags)}")
        bags = [list(b) for b in bags]
        for i, (bag, size) in enumerate(zip(bags, self.cfg.table_sizes)):
            if bag and not (0 <= min(bag) and max(bag) < size):
                raise ValueError(f"feature {i}: ids must lie in [0, {size})")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(RecRequest(uid, np.asarray(dense, np.float32), bags))
        return uid

    # ------------------------------------------------------------- batching

    @staticmethod
    def _bucket(r: RecRequest) -> int:
        return _next_pow2(max((len(b) for b in r.bags), default=1) or 1)

    def _form_wave(self) -> list[RecRequest]:
        """Next wave off the queue.

        ``waves`` mode: strict FIFO slice of up to ``max_batch``.
        Continuous mode: the head request anchors the bag-length bucket; up
        to ``max_batch`` same-bucket requests within the first
        ``lookahead`` queued requests join it, everything else keeps its
        place.
        """
        q = self._queue
        if not q:
            return []
        if self.batching == "waves":
            return [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        anchor = self._bucket(q[0])
        wave: list[RecRequest] = []
        skipped: list[RecRequest] = []
        scanned = 0
        while q and len(wave) < self.max_batch and scanned < self.lookahead:
            r = q.popleft()
            scanned += 1
            if self._bucket(r) == anchor:
                wave.append(r)
            else:
                skipped.append(r)
        for r in reversed(skipped):
            q.appendleft(r)
        return wave

    def _pad_wave(self, wave: list[RecRequest]):
        """(dense (Bb, 13), idx (Bb, F, Lb) int32, mask (Bb, F, Lb) f32).

        ``Lb`` is at least 1 even for an all-empty wave (every bag empty):
        the padded slots carry mask 0, so they pool to zero vectors."""
        f = len(self.modules)
        lb = _next_pow2(max((len(b) for r in wave for b in r.bags), default=1) or 1)
        bb = min(_next_pow2(len(wave)), self.max_batch)
        dense = np.zeros((bb, wave[0].dense.shape[0]), np.float32)
        idx = np.zeros((bb, f, lb), np.int32)
        mask = np.zeros((bb, f, lb), np.float32)
        for b, r in enumerate(wave):
            dense[b] = r.dense
            for i, bag in enumerate(r.bags):
                idx[b, i, :len(bag)] = bag
                mask[b, i, :len(bag)] = 1.0
        self.buckets_seen.add((bb, lb))
        return dense, idx, mask

    # ------------------------------------------------------------- execution

    def _dispatch(self, wave: list[RecRequest]) -> None:
        dense, idx, mask = self._pad_wave(wave)
        t0 = time.monotonic()
        dev = self.device
        with torch.inference_mode():
            feats = self._embed_fwd(torch.from_numpy(idx).to(dev),
                                    torch.from_numpy(mask).to(dev))
            logits = self._dense_fwd(torch.from_numpy(dense).to(dev), feats)
        self._t_first = t0 if self._t_first is None else self._t_first
        self._inflight.append((wave, logits, t0))

    def _reap(self) -> list[RecRequest]:
        wave, logits, t0 = self._inflight.popleft()
        logits = logits.to("cpu", torch.float32).numpy()  # waits for the device
        t1 = time.monotonic()
        self._t_last = t1
        self.wave_latencies_s.append(t1 - t0)
        self.wave_sizes.append(len(wave))
        for b, r in enumerate(wave):  # padded rows beyond len(wave) discarded
            r.score = float(logits[b])
            r.done = True
            self.completed[r.uid] = r
        return wave

    def step(self) -> list[RecRequest]:
        """Form + dispatch one wave, reap what's due; returns finished
        requests.  ``waves`` mode reaps synchronously; continuous mode lets
        up to ``max_inflight`` waves ride asynchronous launches and only
        waits on the oldest beyond that (or drains when the queue is
        empty)."""
        wave = self._form_wave()
        if wave:
            self._dispatch(wave)
        limit = 0 if self.batching == "waves" else self.max_inflight
        done: list[RecRequest] = []
        while self._inflight and (len(self._inflight) > limit or not self._queue):
            done.extend(self._reap())
        return done

    def run_until_drained(self) -> dict[int, RecRequest]:
        while self._queue or self._inflight:
            self.step()
        return self.completed

    # ------------------------------------------------------------- metrics

    def reset_metrics(self) -> None:
        """Drop timing history (after warm-up, so p50/p99 measure steady
        serving rather than first-launch costs)."""
        self.wave_latencies_s = []
        self.wave_sizes = []
        self._t_first = self._t_last = None

    def metrics(self) -> dict:
        lat = np.asarray(self.wave_latencies_s or [0.0])
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        return {
            "requests": int(sum(self.wave_sizes)),
            "waves": len(self.wave_sizes),
            "batching": self.batching,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "qps": (sum(self.wave_sizes) / wall) if wall > 0 else 0.0,
            "buckets": sorted(self.buckets_seen),
        }
