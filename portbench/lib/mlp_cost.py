"""Operations and bytes of DLRM's two MLPs, from their shapes alone, so
that they count the same work whatever implements the MLPs.  FLOPs are two
per multiply-add of each layer's product (bias adds and activations left
out, as ``cost`` counts them); bytes are each layer's f32 input, weights,
bias and output, each once."""

from __future__ import annotations

from portbench.lib import cost


def dlrm_mlps(conf) -> list:
    """The widths of DLRM's bottom and top MLPs, input first."""
    d, f = conf["emb_dim"], cost.n_features(conf)
    return [[conf["dense_dim"], *conf["bottom_mlp"], d],
            [d + f * (f - 1) // 2, *conf["top_mlp"], 1]]


def flops(mlps, n: int) -> int:
    """FLOPs of the MLPs ``mlps`` over ``n`` samples."""
    return 2 * n * sum(cost.mlp_macs(dims) for dims in mlps)


def nbytes(mlps, n: int) -> int:
    """Bytes of the MLPs ``mlps`` over ``n`` samples: per layer ``(i, o)``
    the ``(n, i)`` input, the ``(i, o)`` weights and ``(o,)`` bias, and the
    ``(n, o)`` output, f32."""
    return cost.F32 * sum(n * i + i * o + o + n * o
                          for dims in mlps for i, o in zip(dims[:-1], dims[1:]))
