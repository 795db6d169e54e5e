"""The card: whether the cell can run here, what it is, and its peak
memory."""

from __future__ import annotations

import subprocess

import torch


def missing(chips: int) -> str | None:
    """Why a cell of ``chips`` cards cannot run here, or None."""
    if not torch.cuda.is_available():
        return "no CUDA card: the benchmark measures the port on the card and has no CPU mode"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, this machine has {torch.cuda.device_count()}"
    return None


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({type(err).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def info(chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}
