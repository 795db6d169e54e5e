"""Shared config helpers for the port's architectures: the ``ModelApi``
adapter a config's ``api(cfg)`` returns, the ``Shape`` its batch functions
take, the training batch's structure as ``meta`` tensors (``sds``, the
reference's ``jax.ShapeDtypeStruct``), and ``embedding_spec``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch

from ..core import EmbeddingSpec, factory

__all__ = ["Shape", "ModelApi", "embedding_spec", "resolve_plan", "sds"]


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
    optimizer: Any                      # repro_torch Optimizer
    train_batch: Callable               # (shape: Shape) -> batch of meta tensors
    batch_fn: Callable                  # (step, shape) -> batch of tensors
    predict: Callable                   # (params, batch) -> scores


def sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage: a tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def embedding_spec(embedding: str, num_collisions: int = 4) -> EmbeddingSpec:
    kind = embedding if embedding in factory.KINDS else "qr"
    return EmbeddingSpec(kind=kind, num_collisions=num_collisions, op="mult")


def resolve_plan(plan, table_sizes):
    """A ``repro_torch.plan.MemoryPlan`` (or a path to its JSON artifact,
    written by either package) ready to serve as a config's ``embedding``:
    loads if needed and validates that it was solved for exactly these
    table sizes."""
    from ..plan import MemoryPlan
    if isinstance(plan, (str, bytes, os.PathLike)):
        plan = MemoryPlan.load(plan)
    plan.validate_sizes(table_sizes)
    return plan
