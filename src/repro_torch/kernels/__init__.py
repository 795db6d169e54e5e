"""Hand-written CUDA kernels for the port's lookups and interaction, with
their plain PyTorch versions (``ref``) and the entry points models call
(``ops``)."""

from .ops import dlrm_interact, qr_bag_lookup, qr_lookup, serve_bag_pool

__all__ = ["dlrm_interact", "qr_bag_lookup", "qr_lookup", "serve_bag_pool", "launch_counters"]


def launch_counters():
    """Every kernel wrapper by its kernel's name.  Each adds one to its
    ``launches`` where it launches its kernel (a CUDA operand), and
    nowhere else: the plain versions a CPU operand takes count nothing."""
    from . import dot_interaction, embedding_bag, qr_gather, qr_pairs_backward, serve_path

    return {"fused_serve_pool": serve_path.fused_serve_pool,
            "dot_interaction": dot_interaction.dot_interaction,
            "qr_gather": qr_gather.qr_gather,
            "qr_gather_quant": qr_gather.qr_gather_quant,
            "qr_embedding_bag": embedding_bag.qr_embedding_bag,
            "qr_pairs_backward": qr_pairs_backward.qr_pairs_backward}
