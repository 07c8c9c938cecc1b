"""VGG-16 on 32x32 inputs — the paper's own workload (Figs. 1, 4-8).

The port of ``repro/models/vgg.py``.  The 16 "layers" match the paper's
I = 16 (13 conv + 3 fc); each pool folds into the following layer, exactly
as the profile assumes.  Each layer is an ``nn.Module`` holding a PyTorch-
layout weight (conv ``(out, in, 3, 3)``, dense ``(out, in)``) and a bias.

Layout at the public functions is the reference's: :func:`forward`,
:func:`layer_fwd` and :func:`loss_fn` take and return NHWC images.  Inside,
an NHWC tensor is permuted to an NCHW *view* (channels-last strides, no
copy) for the convolutions, and the map is flattened in NHWC order before
the first dense layer, as the reference flattens it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import cross_entropy

#: ReLU (He) gain for the hidden layers; the logit layer keeps gain 1
_RELU_GAIN = math.sqrt(2.0)

# (kind, out_channels, pool_before), as in the reference
LAYERS = (
    ("conv", 64, False), ("conv", 64, False),
    ("conv", 128, True), ("conv", 128, False),
    ("conv", 256, True), ("conv", 256, False), ("conv", 256, False),
    ("conv", 512, True), ("conv", 512, False), ("conv", 512, False),
    ("conv", 512, True), ("conv", 512, False), ("conv", 512, False),
    ("fc", 4096, True), ("fc", 4096, False), ("fc", 10, False),
)


def _in_features() -> list:
    """Input channels (conv) or fan-in (fc) of every layer at 32x32."""
    out, in_c, hw = [], 3, 32
    for kind, out_c, pool in LAYERS:
        if pool:
            hw //= 2
        if kind == "conv":
            out.append(in_c)
            in_c = out_c
        else:
            out.append(in_c * hw * hw if hw > 1 else in_c)
            in_c, hw = out_c, 1
    return out


class VGGLayer(nn.Module):
    """Layer ``index`` of VGG-16, with its preceding pool if any.  Its
    forward takes the port's internal layout: NCHW maps or flat features."""

    def __init__(self, index: int, in_features: int):
        super().__init__()
        self.index = index
        self.kind, out_c, self.pool = LAYERS[index]
        shape = ((out_c, in_features, 3, 3) if self.kind == "conv"
                 else (out_c, in_features))
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(out_c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool and x.ndim == 4:
            x = F.max_pool2d(x, 2)
        if self.kind == "conv":
            return F.relu(F.conv2d(x, self.weight, self.bias, padding=1))
        if x.ndim == 4:                      # flatten in NHWC order
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.linear(x, self.weight, self.bias)
        return F.relu(x) if self.index < len(LAYERS) - 1 else x


def init_params(generator: torch.Generator) -> nn.ModuleList:
    """The port's initializer: float32 truncated normal (+-2 std) at the
    reference's scales (1/sqrt(fan_in), He gain on hidden layers), drawn on
    the CPU from ``generator`` so a seed gives the same weights on every
    device (move them with ``.to(device)``).  ``jax.random`` streams cannot
    be reproduced in torch; to start from the reference's own weights use
    :func:`params_from_jax`."""
    layers = nn.ModuleList()
    for i, fan in enumerate(_in_features()):
        layer = VGGLayer(i, fan)
        if layer.kind == "conv":
            # the reference's std 1/sqrt(in_c) times gain/3: the fan-in
            # includes the 3x3 window
            scale = _RELU_GAIN / 3.0 / math.sqrt(fan)
        else:
            gain = _RELU_GAIN if i < len(LAYERS) - 1 else 1.0
            scale = gain / math.sqrt(fan)
        with torch.no_grad():
            torch.nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            layer.weight.mul_(scale)
        layers.append(layer)
    return layers


def params_from_jax(params) -> nn.ModuleList:
    """Carry the reference's ``vgg.init_params`` arrays (a list of
    ``{"w", "b"}`` dicts of numpy arrays: HWIO conv weights, ``(fan_in,
    out)`` dense weights) into the port's layers, on the CPU."""
    layers = nn.ModuleList()
    for i, p in enumerate(params):
        w = np.asarray(p["w"])
        # HWIO -> OIHW for conv, (in, out) -> (out, in) for dense
        w = w.transpose(3, 2, 0, 1) if LAYERS[i][0] == "conv" else w.T
        layer = VGGLayer(i, w.shape[1])
        with torch.no_grad():
            layer.weight.copy_(torch.tensor(w))
            layer.bias.copy_(torch.tensor(np.asarray(p["b"])))
        layers.append(layer)
    return layers


def params_to_jax(layers) -> list:
    """The inverse of :func:`params_from_jax`: the reference's layout as a
    list of ``{"w", "b"}`` dicts of numpy arrays."""
    out = []
    for layer in layers:
        w = layer.weight.detach().cpu().numpy()
        w = w.transpose(2, 3, 1, 0) if layer.kind == "conv" else w.T
        out.append({"w": np.ascontiguousarray(w),
                    "b": layer.bias.detach().cpu().numpy()})
    return out


def forward(params, x: torch.Tensor, lo: int = 0,
            hi: int = len(LAYERS)) -> torch.Tensor:
    """Run layers [lo, hi) of ``params`` — the *submodel* abstraction of
    split learning.  4-D inputs and outputs are NHWC."""
    if x.ndim == 4:
        x = x.permute(0, 3, 1, 2)
    for layer in params[lo:hi]:
        x = layer(x)
    if x.ndim == 4:
        x = x.permute(0, 2, 3, 1)
    return x


def layer_fwd(i: int, params, x: torch.Tensor) -> torch.Tensor:
    """Apply layer i (with its preceding pool, if any); NHWC in and out."""
    return forward(params, x, i, i + 1)


def loss_fn(params, batch) -> torch.Tensor:
    logits = forward(params, batch["images"])
    return cross_entropy(logits[:, None, :], batch["labels"][:, None])
