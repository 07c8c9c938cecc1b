"""Shared model pieces — the port of ``repro/models/common.py``: the
architecture config, the initializers, ``rms_norm`` and ``cross_entropy``.

The rest of the reference module (RoPE, the attention paths,
``chunked_linear_scan``, ``remat_wrap``) serves model families the port
does not run yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The fields of the reference's config that the ported family (``ssm``:
    RWKV6) reads, with the reference's defaults; the other families' fields
    come with the slice that first reads them (ROADMAP Queue 1 item 10).
    The reference's ``use_pallas`` switch has no counterpart: in the port
    the tensor's device picks the route (the kernel on CUDA, its plain
    version on the CPU)."""
    name: str
    family: str                   # only "ssm" is ported
    num_layers: int
    d_model: int
    d_ff: int
    vocab: int
    rwkv_head_dim: int = 64
    norm_eps: float = 1e-6
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    scan_chunk: int = 256         # time-chunk of the RWKV linear scan


def dense_init(generator, shape, dtype, device, in_axis: int = -2):
    """Truncated normal (+-2 std) over sqrt(fan_in), drawn in float32 on
    ``device`` from ``generator`` (which must live on that device)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def embed_init(generator, shape, dtype, device):
    """Normal with std 0.02, drawn in float32."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=generator).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


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
