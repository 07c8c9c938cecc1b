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
the layer's ``split.exit`` sums the combine over the model group.  On
DTensors (the dry run) the rules' placements decide the same branches;
where a micro-batch's rows are replicated over the data ranks
(``common.batch_layout``), the experts keep their FSDP blocks and each
product runs on the matching slice, as XLA lays out the reference's
(:func:`_moe_stationary`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import (DATA, WHOLE, ArchConfig, CastCache, ModelSplit,
                     _Constrain, _stationary_mode, dense_init, lay_out,
                     maybe_constrain)


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
        # on a mesh under ``batch_layout`` the experts keep their FSDP
        # blocks: ``_moe_on_mesh`` lays their products out
        return self._cast.get(name, getattr(self, name), dtype,
                              stationary=True)

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


def _per_expert(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (B, E, C, k) times each expert's w (E, k, n) -> (B, E, C, n)."""
    return torch.einsum("becd,edf->becf", a, w)


def _experts(cfg: ArchConfig, buf: torch.Tensor, wg, wu, wd,
             product=_per_expert, blocks: int = 1) -> torch.Tensor:
    """The expert SwiGLU on the dispatch buffer (B, E, C, d), in
    ``moe_ff_chunks`` slices of d_ff when that divides it; ``product``
    multiplies the buffer (or the hidden units) by each expert's matrix
    (on a mesh: :func:`_stationary_product` on an (E, rows, d) buffer),
    and a slice of d_ff is the same slice of each of its ``blocks``
    (:func:`_ff_chunk`)."""
    ff = wg.shape[-1]

    def ffn(g, u, dn):
        h = F.silu(product(buf, g))
        h = h * product(buf, u)
        return product(h, dn)

    n = max(1, cfg.moe_ff_chunks)
    if n > 1 and ff % n == 0:
        acc = torch.zeros_like(buf)
        for i in range(n):
            acc = acc + ffn(*(_ff_chunk(w, dim, i, n, blocks)
                              for w, dim in ((wg, 2), (wu, 2), (wd, 1))))
        return acc
    return ffn(wg, wu, wd)


def _ff_chunk(w: torch.Tensor, dim: int, i: int, n: int,
              blocks: int) -> torch.Tensor:
    """Slice ``i`` of ``n`` of w's d_ff dim ``dim``: one contiguous slice
    (``blocks`` 1, the reference's scan over ff blocks), or slice ``i`` of
    each of ``blocks`` equal blocks (on a mesh whose data ranks hold one
    such block each: every rank's slice is then its own, and no weight
    is gathered; ``blocks * n`` must divide d_ff).  The slices sum to the
    same FFN in another order."""
    f = w.shape[dim] // n
    if blocks == 1:
        return w.narrow(dim, i * f, f)
    shape = list(w.shape)
    v = w.reshape(shape[:dim] + [blocks, n, f // blocks] + shape[dim + 1:])
    return v.select(dim + 1, i).reshape(shape[:dim] + [f] + shape[dim + 1:])


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
    sharded layers): :func:`_moe_on_mesh`, every token routed on every
    model rank, the experts (or their columns) as the rules place them,
    the output a partial sum over "model"."""
    from torch.distributed.tensor import DTensor
    dt = x.dtype
    if isinstance(x, DTensor):
        return _moe_on_mesh(moe, x)
    return _moe(moe.cfg, moe.split, x, moe.w("router", dt),
                *(moe.w(n, dt) for n in ("w_gate", "w_up", "w_down")))


def _moe_on_mesh(moe: MoEFFN, x):
    """``moe_ffn`` on a DTensor.  Under an active ``batch_layout`` with
    experts dealt over "model" and FSDP blocks on the axes where the rows
    are replicated: :func:`_moe_stationary`.  Else one ``local_map``:
    each rank routes and dispatches whole, runs its experts (or their
    columns) on weights gathered over the data axes, and combines; the
    gradients it returns are sums over the ranks that read the input
    their own way (the model group, and the data ranks holding other
    rows)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    dt = x.dtype
    x = maybe_constrain(x, (DATA, None, None))
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    ws = [moe.w(n, dt) for n in ("w_gate", "w_up", "w_down")]
    router = moe.w("router", dt)
    m = names.index("model") if "model" in names else None
    split = WHOLE
    if m is not None and ws[0].placements[m].is_shard():
        split = ModelSplit(mesh.size(m), mesh.get_local_rank("model"))
    mode = _stationary_mode()
    axes = [i for i, n in enumerate(names) if mode is not None
            and n in mode.axes and x.placements[i] == Replicate()
            and any(w.placements[i].is_shard() for w in ws)]
    if axes and expert_parallel(moe.cfg, split):
        return _moe_stationary(moe, x, router, ws, split, axes)
    ws = [lay_out(w, mesh, [p if i == m else Replicate()
                            for i, p in enumerate(w.placements)])
          for w in ws]
    router = lay_out(router, mesh, [Replicate()] * mesh.ndim)
    out = list(x.placements)
    if split.size > 1:
        out[m] = Partial()
    # the data ranks that hold other rows sum the weights' gradients
    rows = [Partial() if p.is_shard() else Replicate() for p in x.placements]
    if m is not None:
        rows[m] = Partial() if split.size > 1 else Replicate()
    grad_x = list(out)
    grad_w = [list(rows) for _ in ws]
    if m is not None:
        for g, w in zip(grad_w, ws):
            g[m] = w.placements[m]
    fn = functools.partial(_moe, moe.cfg, split)
    return local_map(fn, out_placements=out,
                     in_placements=(list(x.placements),
                                    list(router.placements),
                                    *(list(w.placements) for w in ws)),
                     in_grad_placements=(grad_x, rows, *grad_w),
                     device_mesh=mesh)(x, router, *ws)


def _moe_stationary(moe: MoEFFN, x, router, ws, split: ModelSplit,
                    axes: list):
    """The MoE FFN as XLA lays it out for a micro-batch whose rows are
    replicated over the data axes ``axes`` (mesh dims), with experts
    dealt over "model" and FSDP blocks over those axes (the reference
    pins the dispatch buffer to ``P(bd, "model", None, None)``, its batch
    entry dropped): the router product split by ``_WeightStationary``;
    routing and dispatch whole on every rank (a ``local_map``); each
    expert product on the slice of the buffer, or of the hidden units,
    that matches its weight's block (:func:`_stationary_product`), its
    backward too; the combine in a second ``local_map``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    cfg = moe.cfg
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    m = names.index("model") if "model" in names else None
    _, S, d = x.shape
    C = expert_capacity(S, cfg)
    E, K = cfg.moe_experts, cfg.moe_top_k
    n = E // split.size
    # logits whole on every rank: the router product laid out by
    # _WeightStationary, then its partial sums and blocks joined
    logits = lay_out((x @ router).float(), mesh, [Replicate()] * mesh.ndim)

    def rows_at(dim):
        """A tensor's placements with its dim ``dim`` holding the
        rows: split where x's rows are, else replicated."""
        return [Shard(dim) if p.is_shard() else Replicate()
                for p in x.placements]

    def route_dispatch(xl, lg):
        r = route(lg, C, E, K)
        buf, _, _ = dispatch(xl, local_routing(r, split.rank * n, n))
        b = buf.shape[0]
        return (buf.transpose(0, 1).reshape(n, b * C, d),
                r.idx, r.expert, r.token, r.gate, r.keep, r.slot)

    def combine_local(out, idx, expert, token, gate, keep, slot):
        r = Routing(idx, None, expert, token, gate, keep, slot, C, E)
        b = idx.shape[0]
        out = out.reshape(n, b, C, d).transpose(0, 1)
        return combine(out, local_routing(r, split.rank * n, n))

    buf_pl = rows_at(1)
    if m is not None:
        buf_pl[m] = Shard(0)
    pair_pl = rows_at(0)
    x_grad = list(x.placements)
    gate_grad = list(pair_pl)
    y_pl = list(x.placements)
    if m is not None and split.size > 1:
        # each model rank dispatches and combines its own experts' pairs
        x_grad[m] = gate_grad[m] = y_pl[m] = Partial()
    buf, *pairs = local_map(
        route_dispatch, out_placements=(buf_pl,) + (pair_pl,) * 6,
        in_placements=(list(x.placements), list(logits.placements)),
        in_grad_placements=(x_grad, list(logits.placements)),
        device_mesh=mesh)(x, logits)
    # d_ff slices that keep w_down's data blocks in place
    blocks = math.prod(mesh.size(i) for i in axes
                       if ws[2].placements[i].is_shard(1))
    if ws[0].shape[-1] % (max(1, cfg.moe_ff_chunks) * blocks):
        blocks = 1
    out = _experts(cfg, buf, *ws, product=functools.partial(
        _stationary_product, axes), blocks=blocks)
    out = lay_out(out, mesh, buf_pl)
    # (out, idx, expert, token, gate, keep, slot)
    grads = (buf_pl, pair_pl, pair_pl, pair_pl, gate_grad, pair_pl, pair_pl)
    return local_map(
        combine_local, out_placements=y_pl,
        in_placements=(buf_pl,) + (pair_pl,) * 6, in_grad_placements=grads,
        device_mesh=mesh)(out, *pairs)


def _stationary_product(axes: list, a, w):
    """a (E, rows, k) times each expert's w (E, k, n) on a mesh, laid out
    as XLA lays out a product of activations replicated over the mesh
    dims ``axes``: over each, where w's block lies on its contracted dim,
    ``a`` is cut to the matching slice and each rank's partial product is
    summed later; where it lies on the output dim (or nowhere: XLA runs
    the product whole) ``a`` is made whole and the product is already
    split.  The placements are set before the product, so its backward
    (the weight's gradient among it) runs on the same slices: DTensor's
    planner weighs only communication and would run it whole."""
    from torch.distributed.tensor import Replicate, Shard
    place = list(a.placements)
    for i in axes:
        place[i] = Shard(2) if w.placements[i].is_shard(1) else Replicate()
    y = torch.bmm(lay_out(a, a.device_mesh, place), w)
    # its gradient as the product left it, the partial sums summed
    return _Constrain.apply(y, tuple(y.placements))


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
