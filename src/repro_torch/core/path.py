"""Path-based compositional embeddings (paper §4.1, eq. 7).

The first partition indexes a base embedding table; every further partition
selects a *transformation* (a 1-hidden-layer MLP, as in the paper's §5.5
experiments) from a per-bucket parameter bank, and the embedding is the
composition ``M_{k,p_k(x)} ∘ ... ∘ M_{2,p_2(x)} (W e_{p_1(x)})``.

Per-bucket MLP parameters are stored stacked ``(num_buckets, ...)`` and
gathered by bucket index, so the lookup is a fixed-shape gather + einsum.
"""

from __future__ import annotations

import dataclasses

import torch

from .compositional import _uniform
from .partitions import Partition

__all__ = ["PathBasedEmbedding"]


@dataclasses.dataclass(frozen=True)
class PathBasedEmbedding:
    num_categories: int
    dim: int
    partitions: tuple[Partition, ...] = ()
    hidden: int = 64  # paper sweeps {16, 32, 64, 128}; 64 is their best
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.partitions) < 2:
            raise ValueError("path-based embeddings need >= 2 partitions")

    def init(self, generator, device="cuda"):
        scale = (1.0 / self.num_categories) ** 0.5
        dt = self.param_dtype
        params = {"table": _uniform(generator, (self.partitions[0].num_buckets, self.dim),
                                    scale, dt, device)}
        d, h = self.dim, self.hidden
        for j, part in enumerate(self.partitions[1:], start=1):
            n = part.num_buckets
            # LeCun-uniform per slice; biases zero.
            params[f"mlp_{j}"] = {
                "w1": _uniform(generator, (n, d, h), (1 / d) ** 0.5, dt, device),
                "b1": torch.zeros((n, h), dtype=dt, device=device),
                "w2": _uniform(generator, (n, h, d), (1 / h) ** 0.5, dt, device),
                "b2": torch.zeros((n, d), dtype=dt, device=device),
            }
        return params

    def apply(self, params, idx):
        idx = torch.as_tensor(idx)
        h = params["table"][self.partitions[0].bucket(idx).long()]
        for j, part in enumerate(self.partitions[1:], start=1):
            b = part.bucket(idx).long()
            mlp = params[f"mlp_{j}"]
            h = torch.relu(torch.einsum("...d,...dh->...h", h, mlp["w1"][b]) + mlp["b1"][b])
            h = torch.einsum("...h,...hd->...d", h, mlp["w2"][b]) + mlp["b2"][b]
        return h

    @property
    def num_params(self) -> int:
        n = self.partitions[0].num_buckets * self.dim
        d, h = self.dim, self.hidden
        for part in self.partitions[1:]:
            n += part.num_buckets * (d * h + h + h * d + d)
        return n

    @property
    def out_dim(self) -> int:
        return self.dim
