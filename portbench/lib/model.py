"""What the model adapters share: the tables' and MLPs' parameter layout,
the remainder rows of the QR tables, and how the port's embedding spec and
optimizer are built from a configuration's file."""

from __future__ import annotations

import dataclasses

from portbench.reference import embed as ref_embed


def table_layout(conf) -> list:
    """Tables ``U(±S^-1/4)`` for a ``mult`` QR pair (the pair's product has
    a full table's scale), ``U(±S^-1/2)`` otherwise."""
    emb = conf["embedding"]
    out = []
    for i, size in enumerate(conf["table_sizes"]):
        shapes = ref_embed.table_shapes(size, conf["emb_dim"], emb)
        scale = (1.0 / size) ** 0.5
        if len(shapes) == 2 and emb["op"] == "mult":
            scale = scale ** 0.5
        out += [(f"tables/{i}/{k}", shape, "uniform", scale) for k, shape in shapes.items()]
    return out


def mlp_layout(prefix: str, dims) -> list:
    """Weights ``N(0, 2 / fan_in)``, zero biases."""
    out = []
    for j, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"{prefix}/{j}/w", (i, o), "normal", (2.0 / i) ** 0.5),
                (f"{prefix}/{j}/b", (o,), "zeros", 0.0)]
    return out


def remainder_rows(conf) -> list:
    """Each table's remainder row count ``m``, None for a full table."""
    out = []
    for size in conf["table_sizes"]:
        shapes = ref_embed.table_shapes(size, conf["emb_dim"], conf["embedding"])
        out.append(shapes["table_0"][0] if "table_0" in shapes else None)
    return out


def optimizer(conf):
    """The port's optimizer as the file states it."""
    from repro_torch.optim import optimizers as opt
    o = conf["optimizer"]
    if o["kind"] == "amsgrad":
        return opt.adam(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"], amsgrad=True)
    if o["kind"] == "adagrad":
        return opt.adagrad(o["lr"], eps=o["eps"])
    raise ValueError(f"optimizer {o['kind']!r}")


def embedding_spec(conf):
    from repro_torch.core import EmbeddingSpec
    e = conf["embedding"]
    return EmbeddingSpec(kind=e["kind"], num_collisions=e["num_collisions"], op=e["op"],
                         threshold=e.get("threshold", 0))


@dataclasses.dataclass
class Port:
    """The program under test, built from a configuration's file."""
    cfg: object               # the port's config, kernels as the file says
    predict: object           # (params, batch) -> logits
    loss_fn: object           # (params, batch) -> (loss, metrics), plain route
    optimizer: object
    ranges: object            # () -> context manager opening the harness's ranges
