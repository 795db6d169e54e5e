"""Synthetic LM token stream: seeded, stateless per step, learnable.

``batch_at(seed, step, ...)`` keeps the reference generator's contract
without its bits (``jax.random`` draws cannot be reproduced in torch):

  * stateless per ``(seed, step)``: a restarted run replays the exact
    stream, and any step can be drawn alone;
  * sequences follow a planted order-1 Markov chain with a low-rank
    transition structure, ``logits = u[tok] @ v * 2`` with ``u`` (vocab,
    rank) and ``v`` (rank, vocab) standard normal, so a real LM reduces
    the loss well below the uniform entropy.  ``u`` and ``v`` are drawn on
    the CPU from a generator seeded per ``seed`` (a ``zlib.crc32`` tag, as
    ``data.criteo`` seeds its planted weights), so the planted chain is the
    same on every device;
  * ``tokens`` and ``labels`` int32 (B, S), ``labels`` the tokens shifted
    by one, ``mask`` f32 ones.

The start tokens and each step's categorical draw (Gumbel-max) come from
a ``torch.Generator`` on ``device`` seeded per ``(seed, step)``.
``frames_at`` and ``patches_at`` are the stub frontends' inputs.
"""

from __future__ import annotations

import torch

from .criteo import _step_seed

__all__ = ["batch_at", "frames_at", "patches_at"]


def _planted_chain(seed: int, vocab: int, rank: int):
    gen = torch.Generator().manual_seed(_step_seed(seed, 0, f"lm-chain:{vocab}:{rank}"))
    u = torch.randn((vocab, rank), generator=gen)
    v = torch.randn((rank, vocab), generator=gen)
    return u, v


def batch_at(seed: int, step: int, batch_size: int, seq_len: int, vocab: int,
             rank: int = 8, device="cuda"):
    """Deterministic batch for ``(seed, step)`` on ``device``: ``tokens``,
    ``labels`` int32 ``(batch_size, seq_len)`` and ``mask`` f32 ones."""
    u, v = (t.to(device) for t in _planted_chain(seed, vocab, rank))
    gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step, "lm"))
    tok = torch.randint(0, vocab, (batch_size,), generator=gen, device=device)
    seq = [tok]
    for _ in range(seq_len):
        logits = u[tok] @ v * 2.0
        uni = torch.rand(logits.shape, generator=gen, device=device)
        tok = torch.argmax(logits - torch.log(-torch.log(uni)), dim=-1)  # Gumbel-max draw
        seq.append(tok)
    tokens = torch.stack(seq, dim=1).to(torch.int32)                      # (B, S+1)
    return {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous(),
            "mask": torch.ones((batch_size, seq_len), dtype=torch.float32, device=device)}


def frames_at(seed: int, step: int, batch_size: int, n_frames: int, d_model: int,
              device="cuda"):
    """Stub audio-frame embeddings for the seamless frontend."""
    gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step, "frames"))
    return torch.randn((batch_size, n_frames, d_model), generator=gen, device=device) * 0.1


def patches_at(seed: int, step: int, batch_size: int, n_patches: int, d_model: int,
               device="cuda"):
    """Stub anyres patch embeddings for the llava frontend."""
    gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step, "patches"))
    return torch.randn((batch_size, n_patches, d_model), generator=gen, device=device) * 0.1
