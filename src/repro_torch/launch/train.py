"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains a rec-family arch (``dlrm-criteo``, ``dcn-criteo``) on the
synthetic Criteo stream, or an LM arch (``tinyllama-1.1b``,
``qwen3-14b``, ``yi-34b``, ``granite-8b``, ``arctic-480b``,
``deepseek-v2-236b``, the SSM family's ``mamba2-370m`` and
``zamba2-1.2b``, the encoder-decoder ``seamless-m4t-large-v2`` and the
VLM ``llava-next-34b``) on the synthetic LM stream through the arch's
``api.batch_fn`` (``data.lm``, with stub frames or patches for the
multimodal archs; the arch's optimizer, Adam 3e-4 below 30 B parameters
and Adafactor 1e-3 above; the plain path with the flash backward, the
vocabulary through the plain ``embed.apply``, the MoE archs'
load-balance loss added to the loss; ``--seq-len`` sets its sequence
length), as the JAX package's launcher does: the reduced config by
default, ``--no-reduced`` for the full Kaggle tables, a memory
plan through ``--plan`` / ``--plan-budget-mb`` (``launch/plan_cli.py``),
checkpoints under ``--ckpt-dir`` (restart-safe), and ``--trace`` /
``--metrics-out`` for per-step spans and the metrics registry.  Runs on
``--device cuda`` unless told otherwise.  The initial parameters and
every batch are drawn on the CPU and copied, so every device and every
rank sees one stream.

``--compress-policy {auto,none,bf16,int8}`` trains with the explicit
data-parallel step (``train.loop.make_dp_train_step``): each rank takes
its block of the global ``--batch`` and the gradients are reduced with
error-feedback compression (``repro_torch.dist``); with
``--metrics-out`` / ``--trace`` the registry carries the accounted wire
bytes of every leaf per step (``train_wire_bytes_total``).  Under
``torchrun`` the process joins the group from the environment (NCCL for
``cuda``, each rank on its local card; gloo for ``cpu``):

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --compress-policy auto

Without ``torchrun`` it makes a process group of one on the chosen
device, so the step and its collectives still run (at one rank every
ring formula gives 0 bytes).  Rank 0 prints, writes the registry and the
checkpoints; every rank resumes from them.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from .plan_cli import add_plan_args, resolve_plan_args

__all__ = ["main"]


def _join(device_arg: str):
    """The training device, and whether this process started the group:
    under ``torchrun`` (``WORLD_SIZE`` set) the group comes from the
    environment, else a group of one is made here."""
    backend = "nccl" if torch.device(device_arg).type == "cuda" else "gloo"
    if dist.is_initialized():
        return torch.device(device_arg), False
    if "WORLD_SIZE" in os.environ:
        device = torch.device(device_arg)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", **kw)
        return device, True
    from ..dist import world
    device = torch.device(device_arg)
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None else 0)
    world.local(backend)
    return device, True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-criteo")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--embedding", default="qr")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--compress-policy", default=None,
                    choices=["auto", "none", "bf16", "int8"],
                    help="gradient-compression policy for the explicit data-parallel "
                         "step (repro_torch.dist.policy); omit for the plain step")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of per-step spans to PATH "
                         "(implies obs on)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry as JSONL to PATH (implies obs on)")
    ap.add_argument("--device", default="cuda", help="torch device to train on")
    add_plan_args(ap)
    args = ap.parse_args(argv)

    from .. import tree
    from ..configs import get_arch
    from ..configs.common import Shape
    from ..train.loop import (TrainConfig, Trainer, init_dp_state, init_state,
                              make_dp_train_step, make_train_step)

    mod = get_arch(args.arch)
    plan = resolve_plan_args(mod, args)
    if plan is not None:
        cfg = mod.config(reduced=args.reduced, plan=plan)
    else:
        cfg = mod.config(reduced=args.reduced, embedding=args.embedding)

    dp = args.compress_policy is not None or "WORLD_SIZE" in os.environ
    started = False
    if dp:
        device, started = _join(args.device)
        n_dev, rank = dist.get_world_size(), dist.get_rank()
    else:
        device, n_dev, rank = torch.device(args.device), 1, 0
    policy = args.compress_policy or "none"
    talk = rank == 0
    try:
        host = mod.api(cfg, device="cpu")         # parameters and batches drawn on the CPU
        api = mod.api(cfg, device=device)
        shape = Shape("cli", args.seq_len, args.batch, "train")
        params = tree.tree_map(lambda t: t.to(device),
                               host.init(torch.Generator().manual_seed(0)))
        n = sum(p.numel() for p in tree.leaves(params))
        if talk:
            print(f"{args.arch}: {n:,} parameters "
                  f"(embedding={'plan' if plan is not None else args.embedding})")
        if dp:
            if args.batch % n_dev:
                raise SystemExit(f"--batch {args.batch} must be a multiple of the device "
                                 f"count {n_dev} for the dp step")
            state = init_dp_state(params, api.optimizer, compress=policy)
            step = make_dp_train_step(api.loss_fn, api.optimizer, compress=policy)
            if talk:
                print(f"dp step over {n_dev} device(s) ({dist.get_backend()}), "
                      f"compress={policy}")
        else:
            state = init_state(params, api.optimizer)
            step = make_train_step(api.loss_fn, api.optimizer)
        obs = step_wire = None
        if args.trace or args.metrics_out:
            from ..obs import Obs
            obs = Obs(trace=bool(args.trace))
            if dp:
                # accounted per-leaf wire bytes of one dp step -> counters
                from ..dist.accounting import grad_wire_bytes
                from ..dist.policy import resolve_policy
                step_wire = grad_wire_bytes(params, resolve_policy(policy), n_dev)
        del params
        tc = TrainConfig(num_steps=args.steps, log_every=args.log_every,
                         ckpt_every=max(50, args.steps // 4), ckpt_dir=args.ckpt_dir)
        trainer = Trainer(step, tc, obs=obs, step_wire=step_wire,
                          batch_at=lambda s: tree.tree_map(lambda t: t.to(device),
                                                           host.batch_fn(s, shape)))
        if not talk:
            trainer.checkpointer = None             # rank 0 writes; every rank resumes
        state = trainer.resume_or(state)
        state, history = trainer.run(state)
        if talk:
            for s, loss in history:
                print(f"step {s:5d}  loss {loss:.4f}")
            if trainer.straggler_events:
                print("straggler events:", trainer.straggler_events)
            if obs is not None:
                obs.save(metrics_path=args.metrics_out, trace_path=args.trace)
                for p in (args.metrics_out, args.trace):
                    if p:
                        print(f"obs: wrote {p}")
        return history
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
