"""Atomic, verified checkpoints in the JAX package's on-disk format (``checkpoint``)."""
