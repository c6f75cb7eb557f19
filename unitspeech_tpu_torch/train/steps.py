"""Optimizer plumbing of the port's training loops (counterpart of
unitspeech_tpu/train/steps.py)."""

from __future__ import annotations

import torch


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so that their global norm is at most
    max_norm: one norm over every tensor (None entries skipped), scale =
    min(1, max_norm / (norm + 1e-6)). Returns the norm before clipping, a
    device scalar (no host sync)."""
    grads = [g for g in grads if g is not None]
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return gnorm
