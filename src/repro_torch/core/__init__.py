"""The paper's contribution: compositional embeddings over complementary partitions."""

from .compositional import (
    CompositionalEmbedding,
    FullEmbedding,
    HashEmbedding,
    bag_pool,
    is_quantized_table,
    qr_embedding,
    table_rows,
)
from .factory import EmbeddingSpec, make_embedding
from .partitions import (
    ExplicitPartition,
    GeneralizedQRPartition,
    Partition,
    QuotientPartition,
    RemainderPartition,
    codes_for,
    crt_partitions,
    generalized_qr_partitions,
    is_complementary,
    min_collision_free_m,
    naive_partition,
    qr_partitions,
)
from .path import PathBasedEmbedding

__all__ = [
    "CompositionalEmbedding", "FullEmbedding", "HashEmbedding", "bag_pool",
    "qr_embedding", "table_rows", "is_quantized_table", "EmbeddingSpec",
    "make_embedding", "Partition",
    "RemainderPartition", "QuotientPartition", "GeneralizedQRPartition",
    "ExplicitPartition", "codes_for", "crt_partitions",
    "generalized_qr_partitions", "is_complementary", "min_collision_free_m",
    "naive_partition", "qr_partitions", "PathBasedEmbedding",
]
