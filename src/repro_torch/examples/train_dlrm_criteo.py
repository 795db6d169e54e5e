"""End-to-end example: train a ~100M-parameter DLRM with QR embeddings for a
few hundred steps, with checkpointing, restart, and eval — the paper's
training pipeline at example scale, on ``--device`` (default ``cuda``).

The initial parameters and every batch are drawn on the CPU and copied to
the device, so a run on the card and one on the CPU see one stream.

Run: PYTHONPATH=src python -m repro_torch.examples.train_dlrm_criteo [--steps 300]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import EmbeddingSpec
from repro_torch.data.criteo import CriteoSpec, batch_at
from repro_torch.models.dlrm import DLRMConfig, dlrm_init, dlrm_loss_fn, dlrm_num_params
from repro_torch.optim.optimizers import adam, partitioned, rowwise_adagrad
from repro_torch.train.loop import TrainConfig, Trainer, init_state, make_train_step

# ~100M params: mostly embeddings, like production DLRM
TABLE_SIZES = (400_000, 1_200_000, 800_000, 50_000, 21_000, 3_100_000,
               9_000, 110, 4, 960_000)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--embedding", default="qr", choices=["full", "qr", "hash"])
    ap.add_argument("--collisions", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join("artifacts", "train_dlrm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    def on_device(x):
        return tree.tree_map(lambda t: t.to(device, non_blocking=True), x)

    spec = CriteoSpec(table_sizes=TABLE_SIZES, zipf=1.5, noise=0.5)
    cfg = DLRMConfig(
        table_sizes=TABLE_SIZES,
        embedding=EmbeddingSpec(kind=args.embedding, num_collisions=args.collisions,
                                op="mult", threshold=200))
    print(f"embedding={args.embedding}: {dlrm_num_params(cfg):,} parameters "
          f"(full would be {dlrm_num_params(DLRMConfig(table_sizes=TABLE_SIZES)):,})")

    params = on_device(dlrm_init(cfg, torch.Generator().manual_seed(0), "cpu"))
    # the paper's production setup: row-wise adagrad on tables, AMSGrad elsewhere
    opt = partitioned([(lambda p: "tables" in p, rowwise_adagrad(1e-2))],
                      adam(1e-3, amsgrad=True))

    def loss_fn(p, b):
        return dlrm_loss_fn(p, b, cfg)

    state = init_state(params, opt)

    tc = TrainConfig(num_steps=args.steps, log_every=25, ckpt_every=100,
                     ckpt_dir=args.ckpt_dir, keep=2)
    trainer = Trainer(make_train_step(loss_fn, opt, clip_norm=10.0), tc,
                      batch_at=lambda s: on_device(batch_at(0, s, args.batch, spec, "cpu")))
    state = trainer.resume_or(state)  # restart-safe
    if int(state["step"]) > 0:
        print(f"resumed from step {int(state['step'])}")
    state, history = trainer.run(state)
    for step, loss in history:
        print(f"step {step:5d}  loss {loss:.4f}")

    with torch.no_grad():
        losses = [float(loss_fn(state["params"], on_device(batch_at(0, i, args.batch, spec,
                                                                     "cpu")))[0])
                  for i in range(10_000, 10_010)]
    print(f"held-out loss: {np.mean(losses):.4f}")
    if trainer.straggler_events:
        print("straggler events:", trainer.straggler_events)


if __name__ == "__main__":
    main()
