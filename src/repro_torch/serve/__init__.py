"""Serving stack of the port: the wave-batched LM engine (``serve.engine``),
row-wise table quantization and the recsys inference engine."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
