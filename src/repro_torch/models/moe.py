"""Mixture-of-Experts FFN with per-row sort-based capacity dispatch — the
port of ``repro/models/moe.py`` (``granite-moe-3b-a800m``,
``qwen3-moe-235b-a22b``).

Routing runs per batch row, as in the reference: the router's logits
(``x @ router`` in the compute type, then float32), a softmax, the top K
experts of each token with their gates renormalized to sum to one
(:func:`gates_of`), the (token, pick) pairs sorted stably by expert, each
pair's position among its expert's pairs, and a capacity of C slots per
expert (:func:`expert_capacity`): a pair past it is dropped (the residual
keeps the token alive) and goes to a trash slot ``E * C``.  Inside an expert the
pairs are in token order, so which tokens overflow depends only on each
token's top-K set.  The kept pairs fill a dense (B, E, C, d) dispatch
buffer; the expert SwiGLU runs on it as three batched products over the
experts (in ``moe_ff_chunks`` slices of d_ff, accumulated in the
reference's order, when that divides d_ff); the combine sums each token's
kept outputs, each times its gate, in ascending expert order.

The reference has two combines, a scatter over experts (S <= 8192) and a
gather over pairs (longer rows); the gather sums in that order, the
scatter leaves the sum over experts to XLA's reduction (an ulp apart at
K = 8).  The port has one, :func:`combine`: each token's K pairs ordered
by expert, gathered from the buffer and added one pick at a time, as the
gather route — deterministic (no atomics) and O(S * K * d) in memory at
every S.  In training the gradient reaches x through the dispatch and the
router through the gates, as ``jax.grad`` of the reference's does.

Every step is a PyTorch op: the reference reaches no Pallas kernel here.
Its sharding hints lay the experts out over a mesh's "model" axis when
that divides E, else each expert's d_ff.  A layer built with a
``common.ModelSplit`` takes the same two branches: with E % size == 0
(expert parallelism) the rank holds E / size experts, routes every token
with the whole router (the same picks and capacity on every rank),
dispatches only the pairs of its experts and combines only those; else it
holds every expert's block of d_ff columns (rows of ``w_down``), routes
and dispatches everything and combines its partial outputs.  Either way
the layer's ``split.exit`` sums the combine over the model group.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import (DATA, WHOLE, ArchConfig, CastCache, ModelSplit,
                     dense_init, maybe_constrain)


def expert_parallel(cfg: ArchConfig, split: ModelSplit) -> bool:
    """Whether ``split`` deals whole experts (E % size == 0) rather than
    each expert's d_ff columns: the reference's sharding rule."""
    return cfg.moe_experts % split.size == 0


def _shapes(cfg: ArchConfig, split: ModelSplit = WHOLE) -> dict:
    """The MoE parameters of one layer, by shape, in the reference's
    ``init_moe_params`` order (``split``'s block of the experts; the
    router whole)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    El = E
    if expert_parallel(cfg, split):
        El = E // split.size
    else:
        ff = split.part(ff, "expert FFN columns")
    return {"router": (d, E), "w_gate": (El, d, ff), "w_up": (El, d, ff),
            "w_down": (El, ff, d)}


class MoEFFN(nn.Module):
    """The MoE FFN of one layer: ``router`` (d, E), ``w_gate`` and
    ``w_up`` (E, d, ff), ``w_down`` (E, ff, d), in ``cfg.param_dtype``
    and cast to the compute type at use (see ``CastCache``)."""

    def __init__(self, cfg: ArchConfig, device=None,
                 split: ModelSplit = WHOLE):
        super().__init__()
        self.cfg = cfg
        self.split = split
        for name, shape in _shapes(cfg, split).items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=cfg.param_dtype, device=device)))
        self._cast = CastCache()

    def w(self, name: str, dtype) -> torch.Tensor:
        return self._cast.get(name, getattr(self, name), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_ffn(self, x)


def init_moe_params(moe: MoEFFN, generator: torch.Generator) -> None:
    """The reference's initializer, drawn into ``moe`` in place: each
    matrix a truncated normal over sqrt(fan_in) (d for the router,
    ``w_gate`` and ``w_up``; ff for ``w_down``)."""
    cfg = moe.cfg
    with torch.no_grad():
        for name, shape in _shapes(cfg, moe.split).items():
            p = getattr(moe, name)
            p.copy_(dense_init(generator, shape, cfg.param_dtype, p.device))


def expert_capacity(tokens_per_row: int, cfg: ArchConfig) -> int:
    """Slots per expert: ceil(K S / E * cf) rounded up to a multiple of 4,
    at least 4 (the reference's float expression, so the ceil lands the
    same way)."""
    c = math.ceil(cfg.moe_top_k * tokens_per_row / cfg.moe_experts
                  * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


@dataclasses.dataclass
class Routing:
    """One call's routing, per batch row.  ``idx`` / ``gates`` (B, S, K):
    each token's top-K experts and renormalized gates (float32), in top-k
    order.  Over the S * K (token, pick) pairs sorted stably by expert (B,
    S * K): ``expert``, ``token``, ``gate``, ``keep`` (position < C) and
    ``slot`` (``e * C + position``, or ``E * C`` when dropped)."""
    idx: torch.Tensor
    gates: torch.Tensor
    expert: torch.Tensor
    token: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    C: int
    E: int


def route(logits: torch.Tensor, C: int, E: int, K: int) -> Routing:
    """The reference's ``_route_row`` over every row: logits (B, S, E)
    float32 -> :class:`Routing`: the top K of the softmax, their gates
    (:func:`gates_of`), then :func:`assign`."""
    idx = torch.topk(torch.softmax(logits, dim=-1), K, dim=-1).indices
    return assign(idx, gates_of(logits, idx), C, E)


def gates_of(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gates of the picks ``idx`` (B, S, K): the softmax over the
    picked logits.  That is the reference's top-K probabilities divided
    by their sum (the softmax's normalizer cancels; the sum is at least
    K / E, so its 1e-9 floor never binds), with one difference under
    grad: the logit of an expert no token picked gets an exactly zero
    gradient, where the reference's form leaves rounding noise.  Adafactor
    scales each router column by its own gradient's rms, and would blow
    that noise up to a full-size update."""
    return torch.softmax(torch.gather(logits, -1, idx), dim=-1)


def assign(idx: torch.Tensor, gates: torch.Tensor, C: int,
           E: int) -> Routing:
    """Each token's K picks ``idx`` (B, S, K) with their gates ->
    :class:`Routing`: the pairs sorted stably by expert, each pair's
    position in its expert, kept below C, and its slot."""
    B, S, K = idx.shape
    dev = idx.device
    flat_e = idx.reshape(B, S * K)
    flat_t = torch.arange(S, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    expert = torch.gather(flat_e, 1, order)
    token = flat_t[order]
    gate = torch.gather(gates.reshape(B, S * K), 1, order)
    experts = torch.arange(E, device=dev).expand(B, E)
    first = torch.searchsorted(expert, experts.contiguous(), side="left")
    pos = torch.arange(S * K, device=dev) - torch.gather(first, 1, expert)
    keep = pos < C
    slot = torch.where(keep, expert * C + pos, E * C)
    return Routing(idx, gates, expert, token, gate, keep, slot, C, E)


def local_routing(r: Routing, lo: int, n: int) -> Routing:
    """``r`` seen by the holder of experts [lo, lo + n): the same pairs
    in the same order, kept only where kept and theirs, slots counted
    from expert ``lo`` (a pair of another expert goes to the trash slot
    ``n * C``)."""
    mine = r.keep & (r.expert >= lo) & (r.expert < lo + n)
    slot = torch.where(mine, r.slot - lo * r.C, n * r.C)
    return Routing(r.idx, r.gates, r.expert - lo, r.token, r.gate, mine,
                   slot, r.C, n)


def _rows(r: Routing) -> torch.Tensor:
    return torch.arange(r.slot.shape[0], device=r.slot.device)[:, None]


def dispatch(x: torch.Tensor, r: Routing):
    """x (B, S, d) -> (buf (B, E, C, d), tok_slot (B, E, C), w_slot (B,
    E, C)): each slot's token's row of x, its token (S where empty) and its
    gate (float32; 0 where empty), as the reference's ``_route_row``."""
    B, S, d = x.shape
    EC = r.E * r.C
    rows = _rows(r)
    buf = x.new_zeros((B, EC + 1, d)).index_put(
        (rows, r.slot), x[rows, r.token])
    tok = torch.full((B, EC + 1), S, dtype=torch.int32,
                     device=x.device).index_put(
        (rows, r.slot), r.token.to(torch.int32))
    w = torch.zeros((B, EC + 1), dtype=torch.float32,
                    device=x.device).index_put((rows, r.slot),
                                               r.gate.float())
    return (buf[:, :-1].reshape(B, r.E, r.C, d),
            tok[:, :-1].reshape(B, r.E, r.C), w[:, :-1].reshape(B, r.E, r.C))


def combine(out: torch.Tensor, r: Routing) -> torch.Tensor:
    """out (B, E, C, d) -> y (B, S, d): each token's kept outputs times
    their gates (in out's type), summed from zero in ascending expert
    order, one of its K picks at a time."""
    B, E, C, d = out.shape
    S = r.idx.shape[1]
    K = r.idx.shape[2]
    flat = out.reshape(B, E * C, d)
    # the pairs in (token, expert) order: a stable sort by token keeps
    # each token's pairs in the expert order they are sorted in
    by_token = torch.argsort(r.token, dim=-1, stable=True)
    slot, keep, gate = (torch.gather(a, 1, by_token).reshape(B, S, K)
                        for a in (r.slot, r.keep, r.gate))
    rows = torch.arange(B, device=out.device)[:, None]
    slot = slot.clamp_max(E * C - 1)
    y = out.new_zeros((B, S, d))
    for k in range(K):
        contrib = flat[rows, slot[..., k]] * gate[..., k, None].to(out.dtype)
        y = y + torch.where(keep[..., k, None], contrib,
                            torch.zeros((), dtype=out.dtype,
                                        device=out.device))
    return y


def _experts(cfg: ArchConfig, buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The expert SwiGLU on the dispatch buffer (B, E, C, d), in
    ``moe_ff_chunks`` slices of d_ff when that divides it."""
    ff = wg.shape[-1]

    def ffn(g, u, dn):
        h = F.silu(torch.einsum("becd,edf->becf", buf, g))
        h = h * torch.einsum("becd,edf->becf", buf, u)
        return torch.einsum("becf,efd->becd", h, dn)

    n = max(1, cfg.moe_ff_chunks)
    if n > 1 and ff % n == 0:
        f = ff // n
        acc = torch.zeros_like(buf)
        for i in range(n):
            s = slice(i * f, (i + 1) * f)
            acc = acc + ffn(wg[..., s], wu[..., s], wd[:, s])
        return acc
    return ffn(wg, wu, wd)


def router_logits(moe: MoEFFN, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> float32 logits (B, S, E): the product in x's type,
    as the reference's."""
    return (x @ moe.w("router", x.dtype)).float()


def _moe(cfg: ArchConfig, split: ModelSplit, x, router, wg, wu, wd):
    """The MoE FFN on plain tensors: route with the whole ``router``,
    dispatch (only ``split``'s experts under expert parallelism), the
    experts on the given blocks of the weights, combine."""
    C = expert_capacity(x.shape[1], cfg)
    r = route((x @ router).float(), C, cfg.moe_experts, cfg.moe_top_k)
    if split.size > 1 and expert_parallel(cfg, split):
        n = cfg.moe_experts // split.size
        r = local_routing(r, split.rank * n, n)
    buf, _, _ = dispatch(x, r)
    return combine(_experts(cfg, buf, wg, wu, wd), r)


def moe_ffn(moe: MoEFFN, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) (under a split: this rank's part of it,
    which the model group's sum completes).  On a DTensor (the dry run's
    sharded layers) each rank runs its block through ``local_map``:
    every token routed on every model rank, the experts (or their
    columns) as the rules place them, the output a partial sum over
    "model"."""
    from torch.distributed.tensor import DTensor
    dt = x.dtype
    if isinstance(x, DTensor):
        return _moe_on_mesh(moe, x)
    return _moe(moe.cfg, moe.split, x, moe.w("router", dt),
                *(moe.w(n, dt) for n in ("w_gate", "w_up", "w_down")))


def _moe_on_mesh(moe: MoEFFN, x):
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    dt = x.dtype
    x = maybe_constrain(x, (DATA, None, None))
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    ws = [moe.w(n, dt) for n in ("w_gate", "w_up", "w_down")]
    router = moe.w("router", dt)
    router = router.redistribute(mesh, [Replicate()] * mesh.ndim)
    out = list(x.placements)
    split = WHOLE
    if "model" in names:
        ax = names.index("model")
        if ws[0].placements[ax].is_shard():
            split = ModelSplit(mesh.size(ax), mesh.get_local_rank("model"))
            out[ax] = Partial()
    fn = functools.partial(_moe, moe.cfg, split)
    return local_map(fn, out_placements=out,
                     in_placements=(list(x.placements),
                                    list(router.placements),
                                    *(list(w.placements) for w in ws)),
                     device_mesh=mesh)(x, router, *ws)


def aux_load_balance_loss(logits: torch.Tensor, gate_idx: torch.Tensor,
                          cfg: ArchConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e (mean router probability of
    e) * (share of the picks that went to e)."""
    E = cfg.moe_experts
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, E).mean(0)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=E).float()
    ce = ce / torch.clamp_min(ce.sum(), 1.0)
    return E * torch.sum(me * ce)


__all__ = ["MoEFFN", "Routing", "assign", "aux_load_balance_loss", "combine",
           "dispatch", "expert_capacity", "expert_parallel", "gates_of",
           "init_moe_params", "local_routing", "moe_ffn", "route",
           "router_logits"]
