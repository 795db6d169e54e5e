"""Hand-written CUDA kernels for the port's lookups and interaction, with
their plain PyTorch versions (``ref``) and the entry points models call
(``ops``)."""

from .ops import dlrm_interact, qr_bag_lookup, qr_lookup, serve_bag_pool

__all__ = ["dlrm_interact", "qr_bag_lookup", "qr_lookup", "serve_bag_pool"]
