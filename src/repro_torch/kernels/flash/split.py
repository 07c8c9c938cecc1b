"""Split-key attention: the reference's sequence-parallel attention for
query heads that do not split over the "model" axis.

Where the query heads do not divide the model axis, the reference keeps q
whole there and shards the keys' sequence over "model" instead
(``repro/models/common.py::_kv_seq_spec``, ``full_attention`` /
``chunked_attention``; XLA inserts the softmax's sums).  Here each rank of
the group holds q whole (every row and head) and its block of k and v,
the keys at positions ``k_offset .. k_offset + T_m - 1``:

    forward:  (o_m, lse_m) = K2(q, k_m, v_m, k_offset)     (the block)
              lse = log sum_m exp(lse_m)       (the max first, no gradient)
              o   = sum_m exp(lse_m - lse) o_m             (over the group)
    backward: (dq_m, dk_m, dv_m) = K2'(q, k_m, v_m, o, do, lse, k_offset)
              dq = sum_m dq_m;  dk_m, dv_m stay on their rank

K2' given the combined o and lse computes P = exp(s - lse), the block's
share of the whole softmax, and D = rowsum(do o o) of the whole row, so
its algorithm does not change (FlashAttention-2's backward is exact block
by block).  A row with no kept key in a block (every rank's but the first
under the causal mask, for the rows before its block) gets o_m = 0 and
lse_m = -inf from K2, and adds nothing.

The group's sums are a callable, ``reduce(t, op)`` with op "sum" or "max",
that returns ``t`` reduced over the group (in place or not): under the
stage pipeline ``Pipe.all_reduce_`` over the model group
(``pipeline/spmd.py``), so its bytes and seconds land in ``Pipe.bytes`` /
``Pipe.seconds``; on DTensors a functional all-reduce over the mesh dim
the keys are split on (:func:`split_key_attention`), which
``utils/cost.py`` counts.  CUDA tensors go through
:class:`SplitKeyAttention` (K2 and K2' on the block); CPU tensors through
the plain ops with autograd (:func:`_split_plain`: the scores of the block
and their softmax, two products forward and four backward, as the
reference's ``jax.grad`` of ``full_attention`` takes them).
``SplitKeyAttention`` runs the plain versions on CPU tensors too.
"""

from __future__ import annotations

import functools

import torch

from .kernel import _check, _forward, flash_attention_bwd
from .ref import _scores, attention_lse_plain, attention_plain


def key_blocks(T: int, M: int) -> list:
    """[(lo, hi)] of the keys' sequence of length T over M ranks, as
    DTensor's ``Shard`` cuts a dim (``torch.chunk``: blocks of ceil(T / M),
    the last ones shorter or empty)."""
    n = -(-T // M)
    return [(min(m * n, T), min((m + 1) * n, T)) for m in range(M)]


def _combine(lse_m, o_m, reduce):
    """(lse, o) of the whole sequence from the block's (B, H, S) lse_m and
    (B, S, H, hd) float32 o_m, summed over the group by ``reduce``."""
    mx = reduce(lse_m.detach().clone(), "max")
    # a row's max is finite: some block keeps a key of every row
    lse = mx + torch.log(reduce(torch.exp(lse_m - mx), "sum"))
    w = torch.exp(lse_m - lse).transpose(1, 2)[..., None]    # (B, S, H, 1)
    return lse, reduce(w * o_m, "sum")


class SplitKeyAttention(torch.autograd.Function):
    """One rank's part of split-key attention (the module docstring):
    K2 on the block and the combine forward, K2' on the block and the sum
    of dq backward; on CPU tensors the plain versions.  q is the same on
    every rank of the group and so is the output; the gradient that
    arrives is the whole one (the same on every rank), and dq leaves
    summed over the group, dk and dv as the block's."""

    @staticmethod
    def forward(ctx, q, k, v, k_offset: int, causal: bool, window: int,
                reduce):
        B, S, H, hd = q.shape
        if k.shape[1] == 0:               # an empty block keeps no key
            o_m = q.new_zeros((B, S, H, hd), dtype=torch.float32)
            lse_m = q.new_full((B, H, S), float("-inf"),
                               dtype=torch.float32)
        elif q.device.type == "cpu":
            o_m = attention_plain(q, k, v, causal=causal, window=window,
                                  k_offset=k_offset).float()
            lse_m = attention_lse_plain(q, k, causal=causal, window=window,
                                        k_offset=k_offset)
        else:
            o_m, lse_m = _forward(q, k, v, causal, True, window, k_offset)
            o_m = o_m.float()
        lse, o = _combine(lse_m, o_m, reduce)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (k_offset, causal, window, reduce)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        k_offset, causal, window, reduce = ctx.args
        if k.shape[1] == 0:
            dq, dk, dv = torch.zeros_like(q), k.new_zeros(k.shape), \
                v.new_zeros(v.shape)
        else:
            dq, dk, dv = flash_attention_bwd(
                q, k, v, o, do.contiguous(), lse, causal=causal,
                window=window, k_offset=k_offset)
        dq = reduce(dq.float(), "sum").to(q.dtype)
        return dq, dk, dv, None, None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (an input
    that is the same on every rank and read by each in its own way)."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g.clone(), "sum"), None


class _Sum(torch.autograd.Function):
    """The sum over the group; ``partial``: the gradient that arrives is
    each rank's part (summed over the group backward), else the whole one
    (passed on as it is)."""

    @staticmethod
    def forward(ctx, x, reduce, partial: bool):
        ctx.reduce, ctx.partial = reduce, partial
        return reduce(x.clone(), "sum")

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.reduce(g.clone(), "sum")
        return g, None, None


def _split_plain(q, k, v, k_offset, causal, window, reduce):
    """:class:`SplitKeyAttention`'s function in plain ops with autograd
    (CPU tensors): the block's masked scores, their log-sum-exp and
    probabilities (-1e30 where masked: a row with no kept key in the block
    gets an lse near -1e30, a weight of 0 in the combine), o_m = p v_m."""
    B, S, H, hd = q.shape
    q = _SumGrad.apply(q, reduce)
    if k.shape[1] == 0:
        # no key: a weight of 0 in the combine; q, k and v stay in the
        # graph, so that this rank's backward runs the group's sums too
        zero = 0 * (q.float().sum() + k.sum() + v.sum())
        lse_m = q.new_full((B, H, S), -1e30, dtype=torch.float32) + zero
        o_m = q.new_zeros((B, S, H, hd), dtype=torch.float32) + zero
    else:
        scores, g, _ = _scores(q, k, causal, window, k_offset)
        lse_m = torch.logsumexp(scores, dim=-1)
        p = torch.exp(scores - lse_m[..., None])
        vf = v.float().repeat_interleave(g, dim=2)
        o_m = torch.einsum("bhst,bthd->bshd", p, vf)
    mx = reduce(lse_m.detach().clone(), "max")
    lse = mx + torch.log(_Sum.apply(torch.exp(lse_m - mx), reduce, True))
    w = torch.exp(lse_m - lse).transpose(1, 2)[..., None]
    return _Sum.apply(w * o_m, reduce, False).to(q.dtype)


def split_key_local(q, k, v, *, k_offset: int, reduce, causal: bool = True,
                    window: int = 0):
    """One rank's split-key attention on its local tensors: q (B, S, H,
    hd) whole, k and v (B, T_m, KV, hd) its block of the keys at
    ``k_offset``; returns the whole attention output (B, S, H, hd), the
    same on every rank of the group ``reduce`` sums over.  A collective:
    every rank of the group calls it together."""
    if k.shape[1] > 0:
        _check(q, k, v, causal, window, k_offset)
    if q.device.type == "cpu":
        return _split_plain(q, k, v, k_offset, causal, window, reduce)
    return SplitKeyAttention.apply(q, k, v, k_offset, causal, window,
                                   reduce)


def split_key_dim(q, k):
    """The mesh dim over which DTensor k's sequence (dim 1) is split while
    DTensor q is whole there, or None."""
    for d, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pk.is_shard(1) and not pq.is_shard():
            return d
    return None


def _mesh_reduce(mesh, dim: int):
    """``reduce`` over mesh dim ``dim`` by functional all-reduces."""
    from torch.distributed import _functional_collectives as funcol

    def reduce(t, op):
        return funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, dim)))
    return reduce


def split_key_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Split-key attention of DTensors whose keys' sequence is split over
    a mesh dim that q is whole on (:func:`split_key_dim`): every rank runs
    :func:`split_key_local` on its blocks, its ``k_offset`` the start of
    its block on that dim; the output is laid out as q."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    d = split_key_dim(q, k)
    place = [Replicate() if p.is_partial() else p for p in q.placements]
    kv_place = list(place)
    kv_place[d] = Shard(1)
    q = q if list(q.placements) == place else q.redistribute(mesh, place)
    k, v = (t if list(t.placements) == kv_place
            else t.redistribute(mesh, kv_place) for t in (k, v))
    T, M = k.shape[1], mesh.size(d)
    lo = key_blocks(T, M)[mesh.get_local_rank(d)][0]
    fn = functools.partial(split_key_local, k_offset=lo,
                           reduce=_mesh_reduce(mesh, d), causal=causal,
                           window=window)
    return local_map(fn, out_placements=place,
                     in_placements=(place, kv_place, kv_place),
                     device_mesh=mesh)(q, k, v)


__all__ = ["SplitKeyAttention", "key_blocks", "split_key_attention",
           "split_key_dim", "split_key_local"]
