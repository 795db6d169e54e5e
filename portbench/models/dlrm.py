"""DLRM on Criteo (``arch: "dlrm"``).

The benchmark side: the parameter layout of ``repro_torch.models.dlrm``'s
``dlrm_init``, the plain reference and the forward FLOPs.  ``port`` builds
the program under test from the same file: scoring through the kernels
where the file says ``use_kernel``, training through the plain route (the
kernels have no backward).
"""

from __future__ import annotations

import contextlib
import dataclasses

from portbench.lib import cost
from portbench.lib import model as M
from portbench.reference import dlrm as ref_dlrm

forward_flops = cost.dlrm_forward_flops
reference_forward = ref_dlrm.forward
remainder_rows = M.remainder_rows


def layout(conf) -> list:
    d, f = conf["emb_dim"], cost.n_features(conf)
    return (M.table_layout(conf)
            + M.mlp_layout("bottom", [conf["dense_dim"], *conf["bottom_mlp"], d])
            + M.mlp_layout("top", [d + f * (f - 1) // 2, *conf["top_mlp"], 1]))


def port(conf, device) -> M.Port:
    from repro_torch.configs import dlrm_criteo
    from repro_torch.models.dlrm import DLRMConfig

    cfg = DLRMConfig(name="dlrm-criteo", dense_dim=conf["dense_dim"],
                     table_sizes=tuple(conf["table_sizes"]), emb_dim=conf["emb_dim"],
                     bottom_mlp=tuple(conf["bottom_mlp"]), top_mlp=tuple(conf["top_mlp"]),
                     embedding=M.embedding_spec(conf), use_kernel=conf["use_kernel"],
                     param_dtype=conf["param_dtype"])
    train_api = dlrm_criteo.api(dataclasses.replace(cfg, use_kernel=False), device)
    return M.Port(cfg=cfg, predict=dlrm_criteo.api(cfg, device).predict,
                  loss_fn=train_api.loss_fn, optimizer=M.optimizer(conf), ranges=traced_ranges)


@contextlib.contextmanager
def traced_ranges():
    """``portbench.embed`` around the embed stage, ``portbench.interact``
    around the interaction."""
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm

    from portbench.lib.ranges import wrapped
    with wrapped(dlrm, "embed_features", "portbench.embed"), \
            wrapped(ops, "dlrm_interact_concat", "portbench.interact"):
        yield
