"""Gradient/activation compression for bandwidth-constrained links.

The port of ``repro/compression/codecs.py``.  The paper's multi-hop links
are the bottleneck term of Eq. (13) whenever communication dominates;
compressing the cut-layer traffic moves D_k / D'_k (Eqs. 5/9) down by the
codec's ratio, which the planner then re-optimizes around.  Codecs:

  int8     per-tensor affine quantization            (ratio 4x vs fp32)
  top-k    magnitude sparsification + error feedback (ratio ~ k)

Error feedback keeps the residual locally and re-injects it the next round.
The codecs are elementwise ops, one reduction and one top-k on the
tensor's own device; the reference has no Pallas kernel for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..pipeline.executor import LinkHooks


def int8_quantize(x: torch.Tensor):
    """(int8 values, float32 scale) with x ~ q * scale, |q| <= 127."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_sparsify(x: torch.Tensor, k: int):
    """Keep the k largest-|.| entries (flat); returns (values, indices)."""
    flat = x.reshape(-1)
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx


def topk_densify(values: torch.Tensor, idx: torch.Tensor,
                 shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=values.dtype,
                       device=values.device)
    flat[idx] = values
    return flat.reshape(shape)


@dataclasses.dataclass
class ErrorFeedback:
    """Residual accumulator around a biased codec."""
    residual: torch.Tensor | None = None

    def compress(self, x, codec_fwd: Callable, codec_bwd: Callable):
        if self.residual is not None:
            x = x + self.residual.to(x.dtype)
        payload = codec_fwd(x)
        decoded = codec_bwd(payload).to(x.dtype)
        self.residual = x - decoded
        return decoded


def compressed_bytes(nbytes_fp32: float, codec: str,
                     topk_ratio: float = 0.05) -> float:
    """D_k scaling for the latency model / planner."""
    if codec == "none":
        return nbytes_fp32
    if codec == "int8":
        return nbytes_fp32 / 4.0
    if codec == "topk":
        # values (4B) + indices (4B) per kept entry
        return nbytes_fp32 * topk_ratio * 2.0
    raise ValueError(codec)


def make_link_hooks(codec: str = "int8",
                    topk_ratio: float = 0.05) -> LinkHooks:
    """The executor's ``LinkHooks`` applying the codec in both directions.
    Straight-through under autograd: the forward value is the decoded one,
    the gradient passes as if the link were exact."""
    def roundtrip(x):
        if codec == "none":
            return x
        xf = x.to(torch.float32)
        if codec == "int8":
            dec = int8_dequantize(*int8_quantize(xf))
        elif codec == "topk":
            k = max(1, int(xf.numel() * topk_ratio))
            vals, idx = topk_sparsify(xf, k)
            dec = topk_densify(vals, idx, xf.shape)
        else:
            raise ValueError(codec)
        # straight-through estimator
        return x + (dec.to(x.dtype) - x).detach()

    return LinkHooks(fwd=roundtrip, bwd=roundtrip)
