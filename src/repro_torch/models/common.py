"""Shared model pieces — the port of ``repro/models/common.py``'s
``cross_entropy`` (the only piece the VGG training round needs)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross entropy; logits (B, S, V) any float dtype, labels
    (B, S) integers.  The max-shift is a constant (no gradient), and the
    reductions accumulate in float32, as in the reference."""
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    sumexp = torch.exp(shifted).sum(dim=-1, dtype=torch.float32)
    # ignored positions gather index 0 (masked out below): torch.gather
    # rejects a negative index
    idx = labels.long().clamp_min(0)[..., None]
    gold = torch.gather(shifted, -1, idx)[..., 0]
    nll = torch.log(sumexp) - gold.float()
    mask = labels != ignore_id
    return (nll * mask).sum() / mask.sum().clamp_min(1)
