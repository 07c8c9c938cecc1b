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

``attention_lse_plain`` is the forward's second output (the log-sum-exp of
each query row's masked, scaled scores, (B, H, S) float32) and
``flash_bwd_plain`` the backward K2' computes, written out with lse and
D = rowsum(dO o o), as FlashAttention-2 states it:

    P = exp(s - lse),  dP = dO v^T,  dS = P (dP - D)
    dq = dS k / sqrt(hd),  dk = dS^T q / sqrt(hd),  dv = P^T dO

with dk and dv of a kv head summed over its query heads.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, causal):
    """(B, H, S, T) float32 masked, scaled scores and the GQA group."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} "
                         "kv heads")
    g = H // KV
    kf = k.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf)
    scores = scores * (1.0 / math.sqrt(hd))
    if causal:
        qpos = torch.arange(S, device=q.device)
        kpos = torch.arange(T, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, NEG_INF)
    return scores, g


def attention_plain(q, k, v, *, causal: bool = True):
    scores, g = _scores(q, k, causal)
    vf = v.float().repeat_interleave(g, dim=2)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)


def attention_lse_plain(q, k, *, causal: bool = True):
    """(B, H, S) float32: logsumexp of each row's masked, scaled scores."""
    return torch.logsumexp(_scores(q, k, causal)[0], dim=-1)


def flash_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True):
    """(dq, dk, dv) of ``attention_plain`` at the output gradient ``do``,
    from the forward's output ``o`` and log-sum-exp ``lse``; each in its
    input's type."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scores, g = _scores(q, k, causal)
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(scores - lse.float()[..., None])          # (B, H, S, T)
    if causal:
        qpos = torch.arange(S, device=q.device)
        kpos = torch.arange(T, device=q.device)
        p = torch.where(kpos[None, :] <= qpos[:, None], p, 0.0)
    dof = do.float()
    D = (dof * o.float()).sum(-1).transpose(1, 2)           # (B, H, S)
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dk = dk.reshape(B, T, KV, g, hd).sum(3)
    dv = dv.reshape(B, T, KV, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
