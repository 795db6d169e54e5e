"""Prefetching host → device data loader for one process.

``ShardedLoader`` wraps a stateless ``batch_at(step)`` function and:
  * moves every tensor of the batch to ``device`` when one is given (one
    process takes the whole global batch; the reference's ``host_slice``
    of it per process waits for the multi-GPU port, ROADMAP, modules to
    port: item 16b);
  * prefetches ``depth`` batches on a background thread (hides host input
    latency — the straggler-mitigation lever for input-bound steps);
  * is restartable: ``seek(step)`` repositions the stream exactly.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch

__all__ = ["ShardedLoader"]


class ShardedLoader:
    def __init__(self, batch_at: Callable[[int], dict], *, device=None,
                 depth: int = 2, start_step: int = 0):
        self._batch_at = batch_at
        self._device = None if device is None else torch.device(device)
        self._depth = depth
        self._step = start_step
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def seek(self, step: int):
        self._shutdown()
        self._step = step

    def _produce(self, start: int):
        step = start
        while not self._stop.is_set():
            batch = self._batch_at(step)
            if self._device is not None:
                batch = {k: v.to(self._device) for k, v in batch.items()}
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def _ensure(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._q = queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._produce, args=(self._step,), daemon=True)
            self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure()
        step, batch = self._q.get()
        self._step = step + 1
        return batch

    def _shutdown(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None

    def close(self):
        self._shutdown()
