"""Sharded, prefetching host → device data loader.

``ShardedLoader`` wraps a stateless ``batch_at(step)`` function and:
  * slices out this process's rows of the global batch (``host_slice``:
    dim 0 split evenly over the processes of the default
    ``torch.distributed`` group, or the whole batch when no group is
    initialized), so each process feeds only its own rank;
  * moves every tensor of the batch to ``device`` when one is given;
  * prefetches ``depth`` batches on a background thread (hides host input
    latency — the straggler-mitigation lever for input-bound steps);
  * is restartable: ``seek(step)`` repositions the stream exactly.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch

__all__ = ["ShardedLoader", "host_slice"]


def host_slice(batch, *, process_index=None, process_count=None):
    """This process's rows of a global batch: dim 0 split into
    ``process_count`` blocks, block ``process_index``.  Both default to
    the default process group's rank and size (0 and 1 without one)."""
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if grouped else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if grouped else 1) if process_count is None else process_count
    if pc == 1:
        return batch
    per = {k: v.shape[0] // pc for k, v in batch.items()}
    return {k: v[pi * per[k]:(pi + 1) * per[k]] for k, v in batch.items()}


class ShardedLoader:
    def __init__(self, batch_at: Callable[[int], dict], *, device=None,
                 depth: int = 2, start_step: int = 0):
        """``batch_at(step)`` gives the global batch of a step; the process
        index and count of ``host_slice`` are read here, once."""
        import torch.distributed as dist
        grouped = dist.is_available() and dist.is_initialized()
        self._process = ((dist.get_rank(), dist.get_world_size()) if grouped else (0, 1))
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
            batch = host_slice(self._batch_at(step), process_index=self._process[0],
                               process_count=self._process[1])
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
