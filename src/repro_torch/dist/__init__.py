"""Distribution subsystem of the port: compression policy, error-feedback
compressed gradient reduction and wire accounting, on ``torch.distributed``.

``repro_torch.dist.policy`` maps each gradient leaf to a compression mode
through a path+shape rule table (int8 tables / bf16 dense / none for
small or precision-critical leaves).

``repro_torch.dist.compress`` implements bf16/int8 error-feedback
gradient reduction with int8 and bf16 on the wire, used by
``train.loop.make_dp_train_step``.

``repro_torch.dist.accounting`` prices a step's collectives in wire bytes
per device; ``repro_torch.dist.wire`` issues the collectives and counts
the bytes each really hands over, so the two cross-check.

The reference's ``sharding`` (FSDP, ROADMAP item 16b) and
``serve_placement`` (sharded serving, item 16c) are not ported yet.
"""

from . import accounting, compress, policy, wire
from .compress import ef_psum_grads, init_error_state, quantize_int8, resolve_modes
from .policy import AUTO, CompressionPolicy, resolve_policy

__all__ = [
    "compress", "policy", "accounting", "wire",
    "quantize_int8", "init_error_state", "ef_psum_grads", "resolve_modes",
    "AUTO", "CompressionPolicy", "resolve_policy",
]
