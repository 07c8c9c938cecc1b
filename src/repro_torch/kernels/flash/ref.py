"""Plain PyTorch version of the flash-attention forward (K2).

``attention_plain`` is the function K2 computes, written out densely (the
port of ``repro/kernels/flash/ref.py::attention_ref``):

    out = softmax(q k^T / sqrt(hd), mask) v

with the scores, the softmax and the product with v in float32 and the
result cast to q's type.  The causal mask keeps ``kpos <= qpos`` with both
counted from 0 (start-aligned, as the Pallas kernel masks); a sliding
``window`` > 0 also keeps only ``kpos > qpos - window`` (the reference's
``full_attention`` / ``chunked_attention``, ``models/common.py:235-236,
276-277``); masked scores are filled with -1e30, as in the Pallas kernel and
the reference's ``full_attention``.  GQA maps query head h to kv head ``h // (H // KV)``.
Layouts: q (B, S, H, hd); k, v (B, T, KV, hd); returns (B, S, H, hd).

``k_offset`` is the position of key 0: k and v are the block of keys
``k_offset .. k_offset + T - 1`` of a longer sequence (one rank's block of
the keys' sequence, ``split.py``), and the mask compares those positions
with the queries' (from 0).  A query row none of whose keys in the block
is kept gives a zero output row and an lse of -inf (the block adds
nothing to the row's softmax); with ``k_offset`` 0 no row is empty.

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


def _mask(S, T, causal, window, device, k_offset=0):
    """(S, T) bool of the query-key pairs kept, or None when all are."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :] + k_offset
    mask = None
    if causal:
        mask = kpos <= qpos
    if window > 0:
        inside = kpos > qpos - window
        mask = inside if mask is None else mask & inside
    return mask


def _scores(q, k, causal, window, k_offset=0):
    """(B, H, S, T) float32 masked, scaled scores, the GQA group and the
    (S, T) mask (None: every pair kept)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} "
                         "kv heads")
    g = H // KV
    kf = k.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf)
    scores = scores * (1.0 / math.sqrt(hd))
    mask = _mask(S, T, causal, window, q.device, k_offset)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return scores, g, mask


def _empty_rows(mask, k_offset):
    """(S, 1) bool of the query rows with no kept key in the block, or
    None (with ``k_offset`` 0 every row keeps its diagonal)."""
    if mask is None or k_offset == 0:
        return None
    return ~mask.any(dim=-1, keepdim=True)


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    k_offset: int = 0):
    scores, g, mask = _scores(q, k, causal, window, k_offset)
    vf = v.float().repeat_interleave(g, dim=2)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    empty = _empty_rows(mask, k_offset)
    if empty is not None:
        out = torch.where(empty[None, :, :, None], 0.0, out)
    return out.to(q.dtype)


def attention_lse_plain(q, k, *, causal: bool = True, window: int = 0,
                        k_offset: int = 0):
    """(B, H, S) float32: logsumexp of each row's masked, scaled scores
    (-inf for a row with no kept key)."""
    scores, _, mask = _scores(q, k, causal, window, k_offset)
    lse = torch.logsumexp(scores, dim=-1)
    empty = _empty_rows(mask, k_offset)
    if empty is not None:
        lse = torch.where(empty[:, 0], float("-inf"), lse)
    return lse


def flash_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                    window: int = 0, k_offset: int = 0):
    """(dq, dk, dv) of ``attention_plain`` at the output gradient ``do``,
    from the forward's output ``o`` and log-sum-exp ``lse``; each in its
    input's type.  Given the output and lse of the whole sequence's
    softmax (``split.py``'s combine), the gradients of this block of keys:
    dk and dv whole, dq this block's share."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scores, g, mask = _scores(q, k, causal, window, k_offset)
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(scores - lse.float()[..., None])          # (B, H, S, T)
    if mask is not None:
        # a row with no kept key (lse -inf) has every p masked: 0, no NaN
        p = torch.where(mask, p, 0.0)
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
