"""Criteo-format data: the Kaggle table sizes, a seeded synthetic stream,
its drifted twin and a TSV reader.

``batch_at(seed, step, ...)`` keeps the reference generator's contract
without its bits (``jax.random`` draws cannot be reproduced in torch):

  * stateless per ``(seed, step)``: a restarted run replays the exact
    stream, and any step can be drawn alone;
  * categorical ids are power-law, ``min(floor(S·u^zipf), S−1)`` for
    ``u ~ U[0, 1)``, so the share of a feature's draws below ``t·S`` is
    ``t^(1/zipf)``;
  * labels come from a planted logistic model over the dense features and
    low-order harmonics of the category ids, ``score + noise·N(0, 1) > 0``
    with ``score = dense·w_d + Σ sin(sparse·c)·a``.  The planted weights
    are drawn on the CPU from a generator seeded by the same ``zlib.crc32``
    tag as the reference's, so the planted task is the same on every
    device.

The batch is drawn on ``device`` from a ``torch.Generator`` there.  Tests
that compare the port with the reference take the reference's batches
across as numpy arrays.

``drifted_batch_at`` is ``batch_at`` with injected traffic drift
(``DriftSpec``: a Zipf shift that rotates the popularity head and changes
the exponent, and a flash crowd), the stream the online re-planning loop
is proven on.  ``read_tsv`` parses the real Criteo format (label, 13 ints,
26 hex categories) for when the dataset is available.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

__all__ = ["CriteoSpec", "DriftSpec", "KAGGLE_TABLE_SIZES", "batch_at", "drifted_batch_at",
           "drifted_ids", "read_tsv"]

# Criteo Kaggle per-feature cardinalities (rounded, public statistics).
KAGGLE_TABLE_SIZES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)


@dataclasses.dataclass(frozen=True)
class CriteoSpec:
    table_sizes: tuple[int, ...] = KAGGLE_TABLE_SIZES
    dense_dim: int = 13
    zipf: float = 3.0          # idx = floor(S * u^zipf): higher = more skew
    noise: float = 1.0


def _step_seed(seed: int, step: int, tag: str = "step") -> int:
    """One generator seed per ``(seed, step)`` pair and draw ``tag``, in the
    32 bits a CPU ``torch.Generator`` keeps of its seed.  CRC-32 tells apart
    any two tags of one length that differ within 4 bytes, so neighbouring
    steps never share a seed."""
    return zlib.crc32(f"{seed}:{tag}:{step}".encode())


def _draws(seed, step, batch_size, spec, device):
    """The step's dense features, id uniforms and label noise, in the order
    ``batch_at`` draws them from one generator."""
    gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step))
    dense = torch.randn((batch_size, spec.dense_dim), generator=gen, device=device)
    u = torch.rand((batch_size, len(spec.table_sizes)), generator=gen, device=device)
    noise = torch.randn((batch_size,), generator=gen, device=device)
    return dense, u, noise


def _labelled(seed, dense, sparse, noise, spec, device):
    """The planted logistic model's labels on these draws."""
    n_tab = len(spec.table_sizes)
    w_dense = _planted(seed, "wd", (spec.dense_dim,)).to(device)
    a = _planted(seed, "a", (n_tab,)).to(device)
    c = _planted(seed, "c", (n_tab,)).to(device) * 5.0
    score = dense @ w_dense + torch.sum(torch.sin(sparse * c) * a, dim=-1)
    label = (score + spec.noise * noise > 0).to(torch.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


def batch_at(seed: int, step: int, batch_size: int, spec: CriteoSpec, device="cuda"):
    """Deterministic batch for ``(seed, step)`` on ``device``: ``dense``
    f32 ``(B, dense_dim)``, ``sparse`` int32 ``(B, n_tables)``, ``label``
    f32 ``(B,)`` in {0, 1}."""
    dense, u, noise = _draws(seed, step, batch_size, spec, device)
    sizes = torch.tensor(spec.table_sizes, dtype=torch.float32, device=device)
    sparse = torch.minimum(torch.floor(u ** spec.zipf * sizes), sizes - 1).to(torch.int32)
    return _labelled(seed, dense, sparse, noise, spec, device)


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Injected traffic drift for the synthetic stream (the reference's
    streaming-drift scenario).  Two mechanisms, both stateless per
    ``(seed, step)`` so drifted streams replay exactly like ``batch_at``:

    * **Zipf shift** — from ``shift_step`` on, the popularity head
      *rotates* by ``rotate_frac`` of each table (yesterday's hot ids go
      cold, previously-cold mid-range ids become the head) and the zipf
      exponent moves to ``zipf_after``.  A flatter exponent means more
      effective categories, which is what moves measured collision mass
      on hashed/QR tables — rotation alone barely does, because
      ``x mod m`` maps a consecutive hot head to distinct rows wherever it
      starts.
    * **flash crowd** — during ``[crowd_step, crowd_step + crowd_len)``
      a ``crowd_frac`` share of every feature's draws redirects to one
      fixed (previously cold) crowd id per feature, ``(2·S) // 3``.
    """
    shift_step: int | None = None
    rotate_frac: float = 0.5
    zipf_after: float | None = None
    crowd_step: int | None = None
    crowd_len: int = 0
    crowd_frac: float = 0.0

    def shifted(self, step: int) -> bool:
        return self.shift_step is not None and step >= self.shift_step

    def crowded(self, step: int) -> bool:
        return (self.crowd_step is not None and self.crowd_frac > 0
                and self.crowd_step <= step < self.crowd_step + self.crowd_len)

    def active(self, step: int) -> bool:
        return self.shifted(step) or self.crowded(step)


def drifted_ids(u, sizes, zipf: float, rotate_frac: float = 0.0, crowd_u=None,
                crowd_frac: float = 0.0):
    """The drifted id transform on the id uniforms ``u`` ``(B, F)``:
    ``min(floor(S·u^zipf), S−1)``, rotated by ``floor(S·rotate_frac)``
    modulo S, then a ``crowd_frac`` share of the draws (``crowd_u <
    crowd_frac``) sent to ``(2·S) // 3``.  ``sizes`` is the f32 tensor of
    table sizes; returns int32 ids."""
    sparse = torch.minimum(torch.floor(u ** zipf * sizes), sizes - 1).to(torch.int32)
    isizes = sizes.to(torch.int64)
    if rotate_frac:
        off = torch.floor(sizes * rotate_frac).to(torch.int64)
        sparse = ((sparse.to(torch.int64) + off[None, :]) % isizes).to(torch.int32)
    if crowd_u is not None:
        crowd_ids = ((2 * isizes) // 3).to(torch.int32)
        sparse = torch.where(crowd_u < crowd_frac, crowd_ids[None, :], sparse)
    return sparse


def drifted_batch_at(seed: int, step: int, batch_size: int, spec: CriteoSpec,
                     drift: DriftSpec | None = None, device="cuda"):
    """``batch_at`` with ``drift`` applied to the categorical draws.

    Inactive drift (before ``shift_step``, outside the crowd window, or
    ``drift=None``) is bitwise ``batch_at``: the same generator, the same
    draws.  When active, the drifted ids feed the *same* planted logistic
    label model, so the labels reflect the traffic actually drawn.  The
    crowd's pick uniforms are a separate draw from a generator of their
    own (tag ``crowd``), so the step's other draws are those ``batch_at``
    makes."""
    if drift is None or not drift.active(step):
        return batch_at(seed, step, batch_size, spec, device)
    dense, u, noise = _draws(seed, step, batch_size, spec, device)
    sizes = torch.tensor(spec.table_sizes, dtype=torch.float32, device=device)
    shifted = drift.shifted(step)
    zipf = drift.zipf_after if shifted and drift.zipf_after is not None else spec.zipf
    crowd_u = None
    if drift.crowded(step):
        gen = torch.Generator(device=device).manual_seed(_step_seed(seed, step, "crowd"))
        crowd_u = torch.rand(u.shape, generator=gen, device=device)
    sparse = drifted_ids(u, sizes, zipf, drift.rotate_frac if shifted else 0.0, crowd_u,
                         drift.crowd_frac)
    return _labelled(seed, dense, sparse, noise, spec, device)


def _planted(seed: int, tag: str, shape):
    # zlib.crc32, not hash(): Python's string hash is salted per process
    gen = torch.Generator().manual_seed(zlib.crc32(f"{seed}:{tag}".encode()) % (2 ** 31))
    return torch.randn(shape, generator=gen) / shape[0] ** 0.5


def read_tsv(path: str, spec: CriteoSpec, batch_size: int, hash_to_size: bool = True,
             device="cuda"):
    """Stream real Criteo TSV rows (label, ``dense_dim`` ints, hex
    categories; empty fields are 0) as model batches on ``device``: dense
    ``log1p(max(x, 0))`` f32, categories modulo the table sizes (when
    ``hash_to_size``) int32, labels f32.  A last partial batch is dropped,
    as in the reference."""
    dense_buf, sparse_buf, label_buf = [], [], []
    sizes = np.asarray(spec.table_sizes)
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            label = float(parts[0] or 0)
            dense = [float(x) if x else 0.0 for x in parts[1:1 + spec.dense_dim]]
            dense = np.log1p(np.maximum(np.asarray(dense), 0.0))
            cats = np.asarray([int(x, 16) if x else 0 for x in parts[1 + spec.dense_dim:]],
                              np.int64)
            if hash_to_size:
                cats = cats % sizes
            dense_buf.append(dense)
            sparse_buf.append(cats)
            label_buf.append(label)
            if len(label_buf) == batch_size:
                yield {"dense": torch.as_tensor(np.stack(dense_buf), dtype=torch.float32,
                                                device=device),
                       "sparse": torch.as_tensor(np.stack(sparse_buf).astype(np.int32),
                                                 device=device),
                       "label": torch.as_tensor(np.asarray(label_buf), dtype=torch.float32,
                                                device=device)}
                dense_buf, sparse_buf, label_buf = [], [], []
