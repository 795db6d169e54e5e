"""Deep & Cross Network on Criteo (``arch: "dcn"``).

The benchmark side: the parameter layout of ``repro_torch.models.dcn``'s
``dcn_init`` (cross weights ``N(0, 1 / d0)``, zero biases), the plain
reference and the forward FLOPs.  ``port`` builds the program under test
from the same file.  DCN has no kernel route: its embed stage is the plain
per-table gathers.
"""

from __future__ import annotations

import contextlib

from portbench.lib import cost
from portbench.lib import model as M
from portbench.reference import dcn as ref_dcn

forward_flops = cost.dcn_forward_flops
reference_forward = ref_dcn.forward
remainder_rows = M.remainder_rows


def layout(conf) -> list:
    d0 = cost.dcn_x0(conf)
    cross = []
    for j in range(conf["cross_layers"]):
        cross += [(f"cross/{j}/w", (d0,), "normal", (1.0 / d0) ** 0.5),
                  (f"cross/{j}/b", (d0,), "zeros", 0.0)]
    return (M.table_layout(conf) + cross
            + M.mlp_layout("deep", [d0, *conf["deep_mlp"]])
            + M.mlp_layout("out", [d0 + conf["deep_mlp"][-1], 1]))


def port(conf, device) -> M.Port:
    from repro_torch.configs import dcn_criteo
    from repro_torch.models.dcn import DCNConfig

    cfg = DCNConfig(name="dcn-criteo", dense_dim=conf["dense_dim"],
                    table_sizes=tuple(conf["table_sizes"]), emb_dim=conf["emb_dim"],
                    cross_layers=conf["cross_layers"], deep_mlp=tuple(conf["deep_mlp"]),
                    embedding=M.embedding_spec(conf), param_dtype=conf["param_dtype"])
    api = dcn_criteo.api(cfg, device)
    return M.Port(cfg=cfg, predict=api.predict, loss_fn=api.loss_fn,
                  optimizer=M.optimizer(conf), ranges=traced_ranges)


@contextlib.contextmanager
def traced_ranges():
    """``portbench.embed`` around DCN's embed stage."""
    from repro_torch.models import dcn

    from portbench.lib.ranges import wrapped
    with wrapped(dcn, "embed_features", "portbench.embed"):
        yield
