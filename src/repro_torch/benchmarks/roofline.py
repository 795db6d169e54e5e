"""Roofline of the dry run's cells on the H100 (the port's counterpart of
the JAX package's ``benchmarks/roofline.py``).

Per (arch × shape × mesh) cell, the three terms of the per-GPU program
that ``launch.dryrun`` traced, at the H100 constants of ``launch.mesh.HW``:

    compute_t    = flops per GPU / 989 TFLOP/s (bf16 dense)
    memory_t     = bytes per GPU / 3.35 TB/s
    collective_t = wire bytes on ``model`` / 450 GB/s (NVLink, inside a node)
                 + wire bytes on ``data`` / ``pod`` / 50 GB/s (the network:
                   one 400 Gb/s port per GPU, an assumption)

The figures are derived from those constants, not measured.  MODEL_FLOPS
counts the useful work from the port's own configs (6·N·D train, 2·N·D
inference, N without the embedding tables, a MoE's experts at their
active share), so MODEL/counted shows what the program spends beyond it
(remat, capacity padding, attention over every block).  ``roofline_frac``
is useful-compute time over the dominant term: an upper bound on MFU for
this program.
"""

from __future__ import annotations

import glob
import json
import math
import os
from functools import lru_cache

from ..launch.mesh import HW

__all__ = ["model_flops_coeffs", "model_flops", "analyze_cell", "load_cells", "rows",
           "markdown_table"]

OUT_DIR = os.path.join("artifacts", "bench_torch")


@lru_cache(maxsize=None)
def model_flops_coeffs(arch: str):
    """(N_dense_active, N_embed) parameter counts for the MODEL_FLOPS term,
    from the parameters' shapes on the ``meta`` device."""
    import torch

    from .. import tree
    from ..configs import get_arch
    from ..optim.optimizers import leaf_paths
    mod = get_arch(arch)
    cfg = mod.config()
    params = mod.api(cfg, device="meta").init(torch.Generator().manual_seed(0))
    n_embed = n_moe = n_other = 0
    for p, leaf in zip(leaf_paths(params), tree.leaves(params)):
        n = leaf.numel()
        if "embed/" in p or p.startswith("embed"):
            n_embed += n
        elif "/moe/w" in p:
            n_moe += n
        else:
            n_other += n
    lm_cfg = getattr(cfg, "lm", cfg)
    moe_cfg = getattr(lm_cfg, "moe", None)
    active_frac = (moe_cfg.top_k / moe_cfg.n_experts) if moe_cfg else 0.0
    return n_other + n_moe * active_frac, n_embed


def model_flops(arch: str, shape_name: str, devices: int) -> float:
    from ..configs import SHAPES
    shape = SHAPES[shape_name]
    n_active, _ = model_flops_coeffs(arch)
    if shape.kind == "train":
        total = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / devices


def analyze_cell(record: dict, hw: dict = HW) -> dict:
    """The roofline terms of one dry-run record (seconds per call)."""
    fl = record["flops_per_chip"]
    by_axis = record.get("collective_wire_bytes_by_axis", {})
    nvlink = by_axis.get("model", 0.0)
    network = record["collective_wire_bytes_per_chip"] - nvlink
    terms = {"compute": fl / hw["peak_bf16_flops"],
             "memory": record["hbm_bytes_per_chip"] / hw["hbm_bw"],
             "collective": nvlink / hw["nvlink_bw"] + network / hw["network_bw"]}
    dominant = max(terms, key=terms.get)
    mf = model_flops(record["arch"], record["shape"], record["devices"])
    bound_t = max(terms.values())
    mem = record["memory_analysis"]
    return {
        "arch": record["arch"], "shape": record["shape"], "mesh": record["mesh"],
        "compute_t_s": terms["compute"], "memory_t_s": terms["memory"],
        "collective_t_s": terms["collective"],
        "collective_nvlink_t_s": nvlink / hw["nvlink_bw"],
        "collective_network_t_s": network / hw["network_bw"],
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "model_over_counted_flops": mf / fl if fl else 0.0,
        "roofline_frac": (mf / hw["peak_bf16_flops"]) / bound_t if bound_t else 0.0,
        "argument_gb": mem["argument_size_in_bytes"] / 1e9,
        "peak_gb": mem["peak_live_bytes"] / 1e9,
        "fits": mem["peak_live_bytes"] <= hw["hbm_per_gpu"],
    }


def load_cells(art_dir: str = "artifacts/dryrun"):
    out = []
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("ok"):
            out.append(analyze_cell(r))
    return out


def rows(device=None, art_dir: str = "artifacts/dryrun"):
    """CSV rows for ``benchmarks/run.py``: the single-pod cells' bound in
    microseconds (derived, not measured).  ``device`` is not read: the
    figures come from the dry run's records."""
    cells = load_cells(art_dir)
    out = []
    for c in cells:
        if "multipod" in c["mesh"]:
            continue
        bound_us = max(c["compute_t_s"], c["memory_t_s"], c["collective_t_s"]) * 1e6
        out.append((f"roofline/{c['arch']}/{c['shape']}", round(bound_us, 1),
                    f"dominant={c['dominant']};frac={c['roofline_frac']:.3f};derived"))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "roofline.json"), "w") as f:
        json.dump(cells, f, indent=1)
    return out


def _g(x: float) -> str:
    return f"{x:.3g}" if x and math.isfinite(x) else "0"


def markdown_table(cells=None, art_dir: str = "artifacts/dryrun", mesh_filter: str = "pod_32x8"):
    cells = [c for c in (load_cells(art_dir) if cells is None else cells)
             if c["mesh"] == mesh_filter]
    lines = ["| arch | shape | compute s | memory s | NVLink s | network s | dominant | "
             "MODEL/counted | roofline frac | peak GB |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        lines.append(
            f"| {c['arch']} | {c['shape']} | {_g(c['compute_t_s'])} | {_g(c['memory_t_s'])} | "
            f"{_g(c['collective_nvlink_t_s'])} | {_g(c['collective_network_t_s'])} | "
            f"{c['dominant']} | {c['model_over_counted_flops']:.3f} | "
            f"{c['roofline_frac']:.3f} | {c['peak_gb']:.2f} |")
    return "\n".join(lines)
