"""Distribution subsystem of the port: compression policy, error-feedback
compressed gradient reduction and wire accounting, on ``torch.distributed``.

``repro_torch.dist.policy`` maps each gradient leaf to a compression mode
through a path+shape rule table (int8 tables / bf16 dense / none for
small or precision-critical leaves).

``repro_torch.dist.compress`` implements bf16/int8 error-feedback
gradient reduction with int8 and bf16 on the wire, used by
``train.loop.make_dp_train_step`` (all-reduce) and
``make_fsdp_train_step`` (reduce-scatter).

``repro_torch.dist.sharding`` is the path+shape rule engine: the FSDP
step's scatter dims, the serving placement's specs, and the parameters'
DTensor placements on a named mesh (``tree_shardings``, ``constrain``).

``repro_torch.dist.serve_placement`` places serving tables over the ranks
of a group (replicate small sub-tables, row-shard big ones) and fetches
remote rows through a two-phase all-to-all.

``repro_torch.dist.accounting`` prices a step's collectives in wire bytes
per device; ``repro_torch.dist.wire`` issues the collectives and counts
the bytes each really hands over, so the two cross-check.

A rank of a ``torch.distributed`` process group stands where a device of
the reference's mesh stood.
"""

from . import accounting, compress, policy, serve_placement, sharding, wire
from .compress import ef_psum_grads, init_error_state, quantize_int8, resolve_modes
from .policy import AUTO, CompressionPolicy, resolve_policy
from .serve_placement import (ServePlacement, SubTablePlacement, exchange_rows, place_params,
                              plan_placement)
from .sharding import (INFERENCE_OVERRIDES, batch_axes, constrain, constrain_batch,
                       fit_template, model_divides, placement_overrides, placement_specs,
                       scatter_dims, set_batch_shard_axes, spec_for, tree_shardings)

__all__ = [
    "compress", "policy", "accounting", "wire", "sharding", "serve_placement",
    "spec_for", "tree_shardings", "batch_axes", "constrain",
    "constrain_batch", "set_batch_shard_axes", "model_divides",
    "fit_template", "INFERENCE_OVERRIDES", "scatter_dims",
    "placement_overrides", "placement_specs",
    "quantize_int8", "init_error_state", "ef_psum_grads", "resolve_modes",
    "AUTO", "CompressionPolicy", "resolve_policy",
    "ServePlacement", "SubTablePlacement", "plan_placement",
    "place_params", "exchange_rows",
]
