"""Batched LM serving engine: prefill + KV-cache decode over request waves.

Requests are queued, bucketed by prompt length (so right-padded garbage
never enters the causal cache), and executed in *waves*: one batched
prefill, then lock-step batched decode until every sequence in the wave
hits EOS or its token budget, or the cache's ``max_len``.  Finished slots
idle to the wave's end.  The same queue, waves and stops as the JAX
package's ``serve/engine.py``.

Prefill and decode run under ``torch.inference_mode()`` on the engine's
``device``.  Sampling is greedy (``argmax``, first maximum) or by
temperature (a Gumbel-max draw from a ``torch.Generator`` on ``device``
seeded by ``seed``); deterministic given (seed, queue).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, *, prefill_fn: Callable, decode_fn: Callable,
                 make_cache_fn: Callable, batch_size: int, max_len: int,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, device="cuda"):
        """``prefill_fn(tokens, cache) -> (logits (B, 1, V), cache)``,
        ``decode_fn(tokens (B, 1), pos, cache) -> (logits, cache)`` and
        ``make_cache_fn(batch, max_len)`` on ``device``."""
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.make_cache_fn = make_cache_fn
        self.batch_size = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: deque[Request] = deque()
        self._next_uid = 0
        self.completed: dict[int, Request] = {}

    def submit(self, prompt: list[int], max_new_tokens: int = 16) -> int:
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(uid, list(prompt), max_new_tokens))
        return uid

    def _next_wave(self) -> list[Request]:
        if not self._queue:
            return []
        buckets: dict[int, list[Request]] = defaultdict(list)
        for r in self._queue:
            buckets[len(r.prompt)].append(r)
        # largest bucket first: best batch utilisation
        length = max(buckets, key=lambda k: len(buckets[k]))
        wave = buckets[length][: self.batch_size]
        for r in wave:
            self._queue.remove(r)
        return wave

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Next token per row of ``logits`` (B, V), on the host."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        u = torch.rand(logits.shape, generator=self.generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.temperature + gumbel, dim=-1).cpu().numpy()

    def _emit(self, wave, tok, active) -> None:
        for i, r in enumerate(wave):
            if not active[i] or r.done:
                continue
            t = int(tok[i])
            r.output.append(t)
            if (self.eos_id is not None and t == self.eos_id) \
                    or len(r.output) >= r.max_new_tokens:
                r.done = True
                active[i] = False

    def step(self) -> list[Request]:
        """Run one full wave; returns the finished requests."""
        wave = self._next_wave()
        if not wave:
            return []
        b = self.batch_size
        plen = len(wave[0].prompt)
        prompts = np.zeros((b, plen), np.int64)
        for i, r in enumerate(wave):
            prompts[i] = r.prompt
        with torch.inference_mode():
            cache = self.make_cache_fn(b, self.max_len)
            logits, cache = self.prefill_fn(torch.as_tensor(prompts, device=self.device),
                                            cache)
            budget = max(r.max_new_tokens for r in wave)
            active = np.array([i < len(wave) for i in range(b)])
            pos = plen
            tok = self._sample(logits[:, -1])
            self._emit(wave, tok, active)
            for _ in range(budget - 1):
                if not active.any() or pos >= self.max_len - 1:
                    break
                logits, cache = self.decode_fn(torch.as_tensor(tok[:, None], device=self.device),
                                               pos, cache)
                pos += 1
                tok = self._sample(logits[:, -1])
                self._emit(wave, tok, active)
        for r in wave:
            r.done = True
            self.completed[r.uid] = r
        return wave

    def run_until_drained(self) -> dict[int, Request]:
        while self._queue:
            self.step()
        return self.completed
