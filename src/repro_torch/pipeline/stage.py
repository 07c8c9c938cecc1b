"""Submodel (stage) construction from cut layers — the VGG half of
``repro/pipeline/stage.py``.  A stage is an ``nn.Module`` over a slice of
the full model's layer modules (shared, not copied), so updating a stage
updates the model.  The stacked-scan transformer stages are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..models import vgg as vgg_lib


class VGGStage(nn.Module):
    """Layers (lo, hi] of VGG-16 as one split-learning submodel; NHWC in
    and out, as the reference's stages."""

    def __init__(self, lo: int, hi: int, layers: Sequence[nn.Module]):
        super().__init__()
        self.lo, self.hi = lo, hi
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vgg_lib.forward(self.layers, x)


def vgg_stages_from_cuts(cuts: Sequence[int], params) -> list:
    """cuts: 1-based last layer per submodel (SplitSolution.cuts); the
    stages share ``params``' layer modules."""
    return [VGGStage(lo, hi, layers) for (lo, hi), layers
            in zip(_spans(cuts), split_vgg_params(params, cuts))]


def split_vgg_params(params, cuts: Sequence[int]) -> list:
    """The layer modules of each non-empty submodel."""
    return [list(params[lo:hi]) for lo, hi in _spans(cuts)]


def _spans(cuts: Sequence[int]) -> list:
    spans, lo = [], 0
    for hi in cuts:
        if hi > lo:
            spans.append((lo, hi))
            lo = hi
    return spans
