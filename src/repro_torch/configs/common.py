"""Shared config helpers for the port's architectures: the ``ModelApi``
adapter a config's ``api(cfg)`` returns, the ``Shape`` its batch function
takes, and the embedding spec builder.

``ModelApi`` holds the fields the port uses so far (scoring held-out
batches); the optimizer and the training batch structure arrive with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..core import EmbeddingSpec, factory

__all__ = ["Shape", "ModelApi", "embedding_spec"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclasses.dataclass
class ModelApi:
    name: str
    cfg: Any
    init: Callable                      # torch.Generator -> params
    loss_fn: Callable                   # (params, batch) -> (loss, metrics)
    batch_fn: Callable                  # (step, shape) -> batch of tensors
    predict: Callable                   # (params, batch) -> scores


def embedding_spec(embedding: str, num_collisions: int = 4) -> EmbeddingSpec:
    kind = embedding if embedding in factory.KINDS else "qr"
    return EmbeddingSpec(kind=kind, num_collisions=num_collisions, op="mult")
