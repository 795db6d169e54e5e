"""Hand-written CUDA kernels for the serving hot path, with their plain
PyTorch versions (``ref``) and the entry points models call (``ops``)."""

from .ops import dlrm_interact, serve_bag_pool

__all__ = ["dlrm_interact", "serve_bag_pool"]
