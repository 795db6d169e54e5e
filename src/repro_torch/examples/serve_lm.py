"""Serve a small LM (QR-compressed vocab) with batched requests.

Demonstrates the serving engine: queue → length-bucketed waves → batched
prefill → lock-step KV-cache decode, with temperature sampling, and the
vocabulary looked up through K1 on the card.  The reference example's
config (vocab 4,096 as a QR pair with 4 collisions, d 256, 4 layers, f32)
and its two prompt lengths (two waves).

Run: PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import EmbeddingSpec
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import LMConfig
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    cfg = LMConfig(name="serve-demo", vocab=4096, d_model=256, n_layers=4,
                   n_heads=8, n_kv_heads=4, d_head=32, d_ff=704,
                   embedding=EmbeddingSpec(kind="qr", num_collisions=4),
                   param_dtype="float32", compute_dtype="float32")
    params = lm_mod.init(torch.Generator(device=device).manual_seed(0), cfg, device)

    engine = ServeEngine(
        prefill_fn=lambda toks, cache: lm_mod.prefill(params, toks, cache, cfg),
        decode_fn=lambda tok, pos, cache: lm_mod.decode_step(params, tok, pos, cache, cfg),
        make_cache_fn=lambda b, ml: lm_mod.make_decode_cache(cfg, b, ml, device),
        batch_size=8, max_len=128, temperature=0.8, seed=0, device=device)

    # a burst of requests with two prompt lengths (two waves)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8]] * 10 + [[42, 43, 44]] * 5
    uids = [engine.submit(p, max_new_tokens=16) for p in prompts]
    t0 = time.monotonic()
    done = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    total_tokens = sum(len(r.output) for r in done.values())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.0f} tok/s on {where})")
    for uid in uids[:3]:
        print(f"request {uid}: {done[uid].output}")
    return done


if __name__ == "__main__":
    main()
