"""Submodel (stage) construction from cut layers — the port of
``repro/pipeline/stage.py``.

Two parameter layouts, as in the reference:
  - *list-per-layer* (VGG): a stage is an ``nn.Module`` over a slice of the
    full model's layer modules (shared, not copied), so updating a stage
    updates the model;
  - *stacked* (the language models): per-layer parameters stacked on a
    leading ``L`` axis, a dict in the reference's layout
    (``params_to_jax``'s ``"layers"``); a stage takes its ``[lo:hi]`` slice
    and runs its own block of layers; ``spmd.py`` runs the stages across
    ranks.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn
from torch.func import functional_call

from .._device import resolve_device
from ..models import transformer as tf_lib
from ..models import vgg as vgg_lib
from ..models.common import WHOLE, ArchConfig, ModelSplit, remat_wrap, \
    rope_cos_sin
from ..utils.treemath import tree_map

# ---------------------------------------------------------------------------
# VGG (list-per-layer) stages — the paper's edge-SL submodels
# ---------------------------------------------------------------------------


class VGGStage(nn.Module):
    """Layers (lo, hi] of VGG-16 as one split-learning submodel; NHWC in
    and out, as the reference's stages."""

    def __init__(self, lo: int, hi: int, layers: Sequence[nn.Module]):
        super().__init__()
        self.lo, self.hi = lo, hi
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vgg_lib.forward(self.layers, x)

    @staticmethod
    def init(lo: int, hi: int, generator: torch.Generator,
             device="cuda") -> nn.ModuleList:
        """The counterpart of the reference's ``VGGStage(lo, hi).init(rng)``:
        layers [lo, hi) of a whole-model ``vgg.init_params(generator)``
        (drawn on the CPU), on ``device`` (``"cuda"`` unless the caller
        passes ``"cpu"``)."""
        dev = resolve_device(device)
        layers = vgg_lib.init_params(generator)
        return nn.ModuleList(layers[i].to(dev) for i in range(lo, hi))


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


# ---------------------------------------------------------------------------
# Stacked transformer stages
# ---------------------------------------------------------------------------

def stack_stage_params(layer_params: dict, num_stages: int) -> dict:
    """(L, ...) stacked layers -> (num_stages, L / num_stages, ...), over
    every leaf of the (possibly nested: ``"moe"``) dict."""
    def resh(x):
        L = x.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers do not split into {num_stages} "
                             "stages")
        return x.reshape((num_stages, L // num_stages) + tuple(x.shape[1:]))
    return tree_map(resh, layer_params)


def unstack_stage_params(stage_params: dict) -> dict:
    """The inverse of :func:`stack_stage_params`."""
    return tree_map(lambda x: x.reshape((x.shape[0] * x.shape[1],)
                                        + tuple(x.shape[2:])), stage_params)


def _named(tree: dict, prefix: str = "") -> dict:
    """A nested dict of tensors -> {dotted name: tensor}, the names
    ``named_parameters`` gives a layer's parameters (``moe.router``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _block(layer, cfg, params, x):
    cos = sin = None
    if cfg.use_rope:
        cos, sin = rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                                cfg.head_dim, cfg.rope_theta)
    return functional_call(layer, params, (x, cos, sin))[0]


def transformer_stage_fn(cfg: ArchConfig, tp: ModelSplit = WHOLE):
    """Returns ``f(stage_layers, x)`` running one stage's block of
    :class:`~repro_torch.models.transformer.TransformerLayer`s, from
    position 0, each under ``remat_wrap(cfg.remat)``: ``stage_layers`` is a
    dict of (n, ...) stacked tensors (a slice of
    :func:`stack_stage_params`, the experts nested under ``"moe"``; under
    ``tp`` this rank's block of each along the "model" axis), x is (B, S,
    d), whole on every model rank.  With ``tp`` the layers are
    Megatron-style column and row blocks: H hd / tp query and KV hd / tp
    kv columns (whole heads where the heads split; else the reference's
    layouts, ``transformer.py::attention_mode``: kv heads gathered over
    the group, or every head gathered and the keys' sequence split over
    it), d_ff / tp columns (or E / tp experts), their outputs summed over
    the model group by ``tp.exit``."""
    layer = tf_lib.TransformerLayer(cfg, device="meta", split=tp)
    body = remat_wrap(functools.partial(_block, layer, cfg), cfg.remat)

    def stage_fn(stage_layers: dict, x: torch.Tensor) -> torch.Tensor:
        named = _named(stage_layers)
        n = next(iter(named.values())).shape[0]
        for i in range(n):
            x = body({k: v[i] for k, v in named.items()}, x)
        return x

    return stage_fn
