"""Quickstart: the paper's technique in 40 lines.

Builds a QR compositional embedding, shows uniqueness + compression, and
swaps it into a DLRM via EmbeddingSpec.  Parameters and the batch are
drawn on the CPU and copied to ``--device``, so every device prints the
same numbers.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import (EmbeddingSpec, FullEmbedding, is_complementary, qr_embedding,
                              qr_partitions)
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.models.dlrm import DLRMConfig, dlrm_init, dlrm_loss_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)

    def on_device(x):
        return tree.tree_map(lambda t: t.to(device), x)

    # --- 1. complementary partitions (paper §3) ---------------------------
    size = 10_000
    parts = qr_partitions(size, m=2500)  # quotient + remainder
    if not is_complementary(parts, size):
        raise SystemExit("the quotient and remainder partitions are not complementary")
    print(f"partitions: {parts[0].num_buckets} remainder buckets, "
          f"{parts[1].num_buckets} quotient buckets")

    # --- 2. compositional embedding (paper §2/§4) --------------------------
    emb = qr_embedding(size, dim=16, num_collisions=4, op="mult")
    params = on_device(emb.init(torch.Generator().manual_seed(0), "cpu"))
    full = FullEmbedding(size, 16)
    print(f"params: full={full.num_params:,} qr={emb.num_params:,} "
          f"({full.num_params / emb.num_params:.1f}x smaller)")

    # every category still gets a UNIQUE embedding (Theorem 1)
    with torch.no_grad():
        rows = emb.apply(params, torch.arange(size, device=device)).cpu().numpy()
    if len(np.unique(rows.round(8), axis=0)) != size:
        raise SystemExit("uniqueness: two categories share a vector")
    print("uniqueness: all", size, "categories map to distinct vectors")

    # --- 3. drop into a model via EmbeddingSpec ----------------------------
    spec = EmbeddingSpec(kind="qr", num_collisions=4, op="mult", threshold=200)
    cfg = DLRMConfig(table_sizes=(1000, 50_000, 120, 8), embedding=spec)
    model_params = on_device(dlrm_init(cfg, torch.Generator().manual_seed(1), "cpu"))
    batch = on_device(batch_at(0, 0, 32, CriteoSpec(table_sizes=cfg.table_sizes), "cpu"))
    with torch.no_grad():
        loss, metrics = dlrm_loss_fn(model_params, batch, cfg)
    print(f"DLRM-with-QR forward: loss={float(loss):.4f} acc={float(metrics['acc']):.3f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
