"""Plain PyTorch version of the flash-attention forward (K2).

``attention_plain`` is the function K2 computes, written out densely (the
port of ``repro/kernels/flash/ref.py::attention_ref``):

    out = softmax(q k^T / sqrt(hd), mask) v

with the scores, the softmax and the product with v in float32 and the
result cast to q's type.  The causal mask keeps ``kpos <= qpos`` with both
counted from 0 (start-aligned, as the Pallas kernel masks); masked scores
are filled with -1e30, as in the Pallas kernel and the reference's
``full_attention``.  GQA maps query head h to kv head ``h // (H // KV)``.
Layouts: q (B, S, H, hd); k, v (B, T, KV, hd); returns (B, S, H, hd).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_plain(q, k, v, *, causal: bool = True):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} "
                         "kv heads")
    g = H // KV
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf)
    scores = scores * (1.0 / math.sqrt(hd))
    if causal:
        qpos = torch.arange(S, device=q.device)
        kpos = torch.arange(T, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)
