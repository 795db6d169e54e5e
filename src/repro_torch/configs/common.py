"""Shared config helpers for the port's architectures."""

from __future__ import annotations

from ..core import EmbeddingSpec, factory

__all__ = ["embedding_spec"]


def embedding_spec(embedding: str, num_collisions: int = 4) -> EmbeddingSpec:
    kind = embedding if embedding in factory.KINDS else "qr"
    return EmbeddingSpec(kind=kind, num_collisions=num_collisions, op="mult")
