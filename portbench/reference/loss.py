"""Binary cross-entropy on logits, the stable form, as a mean."""

from __future__ import annotations

import torch


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    x, y = logits.to(torch.float32), labels.to(torch.float32)
    return torch.mean(torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x))))
