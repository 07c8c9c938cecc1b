"""SPMD pipeline parallelism — the paper's pipelined split learning across
devices, on ``torch.distributed``; the port of ``repro/pipeline/spmd.py``.

A mesh of ("data", "stage") ranks (a "pod" axis folds into data).  Stage
k's block of layers lives on the ranks of stage k only: the local
parameter tree of a rank (:func:`shard_params`) holds its stage's slice of
the stacked layers (``stage.py::stack_stage_params``) beside the embedding,
final norm and head, which every rank holds whole (replicated, outside the
pipe, as in the reference).  Activations hop stage -> stage + 1 (the
paper's inter-server transmissions, Eqs. 5/6) and their gradients hop
back (Eqs. 9/10): a hop is an ``autograd.Function`` whose forward sends to
k + 1 and receives from k - 1 and whose backward sends the gradient to
k - 1 and receives from k + 1, the send and receive of each tick issued
together.

Schedule: the reference's GPipe fill / steady / drain over T = Q + S - 1
ticks (Eq. 14's T_f + (Q - 1) T_i): at tick t stage 0 takes micro-batch
min(t, Q - 1), every stage runs its layers (``stage.py::
transformer_stage_fn``, remat included) on what it holds, and the last
stage's outputs from tick S - 1 on are the result.  The cuts' count and Q
come from ``core/planner.py`` (:func:`plan_to_pipeline_config`).

Dtypes as in the reference: the stream of embedded micro-batches is
float32 and cast to the compute type inside; the combine (the last
stage's outputs to every stage rank) is a float32 all-reduce over the
stage group.  The head's Q micro-batches are dealt round-robin over the
stage ranks (q -> rank q mod S), so the head runs once, not S times (a
rank left with none when Q < S still takes part in the backward); the
loss is their sum over the stage group, averaged over the data group.
Gradients as JAX's transposes give them: the combine's backward sums the
cotangents over the stage group; the replicated leaves' gradients are
summed over the stage group and averaged over the data group, the stage
leaves' averaged over the data group — inside the backward, so
``torch.autograd.grad(loss, leaves)`` returns the whole gradient on every
rank.  Every rank builds the same autograd graph, so its backward issues
the hops and reductions in the same order on every rank.

Transport: the process group's backend as the caller set it up.  NCCL
where each rank has a GPU of its own; gloo where ranks share one (NCCL
refuses two ranks on a GPU): gloo moves host memory, so a hop, the
combine and the gradient reductions of CUDA tensors go through pinned
host buffers (kept per shape, reused every tick and step), while all
compute stays on the device.  A CPU tensor under gloo
moves as it is.  A failed collective raises; nothing falls back.

A "model" axis of size > 1 (tensor parallelism inside a stage) is ROADMAP
Queue 1 item 11b and raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..launch.mesh import as_layout
from ..models.common import ArchConfig, cross_entropy, rms_norm
from ..utils.treemath import tree_leaves, tree_map
from .stage import transformer_stage_fn


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_stages: int
    num_microbatches: int
    stage_axis: str = "stage"


def _coords(mesh, pcfg: PipelineConfig) -> tuple:
    """(grid, d, k): the mesh's global ranks as a (D, S) grid (data axes
    and the size-1 model axis major, stage minor) and this rank's row d
    and stage k in it."""
    lay = as_layout(mesh)
    ax = pcfg.stage_axis
    known = ("pod", "data", ax, "model")
    if ax not in lay.axis_names:
        raise ValueError(f"the mesh {lay.axis_names} has no {ax!r} axis")
    for a in lay.axis_names:
        if a not in known:
            raise ValueError(f"mesh axis {a!r} is none of {known}")
    if lay.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "a 'model' axis of size > 1 (tensor parallelism inside a "
            "stage) is ROADMAP Queue 1 item 11b")
    if lay.shape[ax] != pcfg.num_stages:
        raise ValueError(f"the mesh's {ax!r} axis has {lay.shape[ax]} "
                         f"ranks, the pipeline {pcfg.num_stages} stages")
    ranks = mesh.mesh if hasattr(mesh, "mesh") else \
        torch.arange(lay.size).reshape(lay.sizes)
    order = [i for i, a in enumerate(lay.axis_names) if a != ax] + \
        [lay.axis_names.index(ax)]
    grid = np.asarray(ranks.permute(order).reshape(-1, pcfg.num_stages)
                      .tolist())
    me = dist.get_rank()
    where = np.argwhere(grid == me)
    if len(where) != 1:
        raise ValueError(f"rank {me} is not in the mesh {grid.tolist()}")
    return grid, int(where[0][0]), int(where[0][1])


class Pipe:
    """This rank's place in the mesh: its stage k of S, its data index d of
    D, the process groups of its stage row and its data column (every rank
    creates every group, in the same order: a collective), its
    neighbours' global ranks, and how tensors move (``transport``:
    "direct", or "host-staged" for CUDA tensors under gloo).  ``seconds``
    adds up the host's time in each kind of transfer ("hop", "hop_back",
    "combine", "combine_back", "grad_reduce", "loss_reduce"); a
    host-staged transfer's copy to the host first waits for the device's
    queued work."""

    def __init__(self, mesh, pcfg: PipelineConfig, device):
        grid, self.d, self.k = _coords(mesh, pcfg)
        self.device = device
        self.S = pcfg.num_stages
        self.D = grid.shape[0]
        rows = [dist.new_group([int(r) for r in row]) for row in grid]
        cols = [dist.new_group([int(r) for r in col]) for col in grid.T]
        self.stage_group = rows[self.d]
        self.data_group = cols[self.k] if self.D > 1 else None
        self.prev = int(grid[self.d, self.k - 1]) if self.k > 0 else None
        self.next = int(grid[self.d, self.k + 1]) if self.k < self.S - 1 \
            else None
        self.backend = dist.get_backend(self.stage_group)
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors; pass device='cuda'")
        self.host = self.backend != "nccl" and device.type == "cuda"
        self.transport = "host-staged" if self.host else "direct"
        self.seconds = dict.fromkeys(("hop", "hop_back", "combine",
                                      "combine_back", "grad_reduce",
                                      "loss_reduce"), 0.0)
        self._buffers = {}

    def _buffer(self, role: str, like: torch.Tensor) -> torch.Tensor:
        """A host buffer shaped like ``like`` for one role ("send",
        "recv", "reduce"), pinned for a CUDA device; every transfer waits
        for its own completion, so the next one may reuse it."""
        key = (role, tuple(like.shape), like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(
                like.shape, dtype=like.dtype,
                pin_memory=self.device.type == "cuda")
        return buf

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        if not self.host:
            return t.detach().contiguous()
        return self._buffer("send", t).copy_(t.detach())

    def _p2p(self, send, dst, like, src, what):
        t0 = time.perf_counter()
        ops, buf = [], None
        if send is not None and dst is not None:
            ops.append(dist.P2POp(dist.isend, self._wire(send), dst,
                                  self.stage_group))
        if src is not None:
            buf = self._buffer("recv", like) if self.host else \
                torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, buf, src, self.stage_group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if buf is not None and self.host:
            buf = buf.to(self.device, copy=True)
        self.seconds[what] += time.perf_counter() - t0
        return buf

    def forward_hop(self, y):
        return self._p2p(y, self.next, y, self.prev, "hop")

    def backward_hop(self, g):
        return self._p2p(g, self.prev, g, self.next, "hop_back")

    def all_reduce_(self, t: torch.Tensor, group, what: str) -> torch.Tensor:
        """Sum ``t`` over ``group`` in place (None: a group of one)."""
        if group is None or dist.get_world_size(group) == 1:
            return t
        t0 = time.perf_counter()
        if self.host:
            h = self._buffer("reduce", t).copy_(t.detach())
            dist.all_reduce(h, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=group)
        self.seconds[what] += time.perf_counter() - t0
        return t


class _Hop(torch.autograd.Function):
    """y on stage k -> stage k + 1; returns what stage k - 1 sent (zeros on
    stage 0).  Backward: the gradient of what was received goes back to
    k - 1, and the gradient of y comes from k + 1 (zeros on the last)."""

    @staticmethod
    def forward(ctx, y, pipe):
        ctx.pipe = pipe
        got = pipe.forward_hop(y)
        return got if got is not None else torch.zeros_like(y)

    @staticmethod
    def backward(ctx, g):
        got = ctx.pipe.backward_hop(g.contiguous())
        return (got if got is not None else torch.zeros_like(g)), None


class _Combine(torch.autograd.Function):
    """Sum over the stage group (only the last stage's outputs are
    nonzero); the backward sums the cotangents, each rank holding those of
    the micro-batches whose head it ran."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return pipe.all_reduce_(x.clone(), pipe.stage_group, "combine")

    @staticmethod
    def backward(ctx, g):
        return ctx.pipe.all_reduce_(g.clone(), ctx.pipe.stage_group,
                                    "combine_back"), None


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the stage
    group (``over_stage``: a replicated leaf) and averages it over the
    data group."""

    @staticmethod
    def forward(ctx, x, pipe, over_stage):
        ctx.pipe, ctx.over_stage = pipe, over_stage
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        g = g.clone()
        if ctx.over_stage:
            pipe.all_reduce_(g, pipe.stage_group, "grad_reduce")
        if pipe.data_group is not None:
            pipe.all_reduce_(g, pipe.data_group, "grad_reduce").div_(pipe.D)
        return g, None, None


def _reduced(pipe: Pipe, x: torch.Tensor, over_stage: bool):
    if not x.requires_grad or (pipe.data_group is None
                               and (not over_stage or pipe.S == 1)):
        return x
    return _ReduceGrad.apply(x, pipe, over_stage)


def _check_config(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"the stage pipeline runs the transformer's layers; "
                         f"family {cfg.family!r} has none")


def _head_logits(cfg: ArchConfig, params: dict, y: torch.Tensor):
    """The reference's ``_unembed`` (``Transformer.logits``)."""
    x = rms_norm(y, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return x @ params["lm_head"].to(x.dtype)


def shard_params(params: dict, mesh, pcfg: PipelineConfig,
                 device="cuda") -> dict:
    """This rank's parameter tree from the reference's whole tree
    (``nest_layers`` of a model's named parameters, or numpy arrays):
    the replicated leaves whole and ``"layers"`` cut to this rank's stage,
    each a leaf tensor on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``) that requires grad."""
    dev = resolve_device(device)
    _, _, k = _coords(mesh, pcfg)
    S = pcfg.num_stages

    def leaf(x, rows=None):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if rows is not None:
            t = t[rows]
        return t.detach().to(dev).clone().requires_grad_(True)

    def stage_slice(tree):
        if isinstance(tree, dict):
            return {name: stage_slice(v) for name, v in tree.items()}
        L = tree.shape[0]
        if L % S:
            raise ValueError(f"{L} layers do not split into {S} stages")
        n = L // S
        return leaf(tree, slice(k * n, (k + 1) * n))

    return {k: (stage_slice(v) if k == "layers" else leaf(v))
            for k, v in params.items()}


def make_pipelined_loss(cfg: ArchConfig, mesh, pcfg: PipelineConfig,
                        device="cuda") -> Callable:
    """Returns ``loss(params, batch)`` running the layers through the stage
    pipeline, on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``).  ``params`` is this rank's tree (:func:`shard_params`);
    ``batch`` the whole global batch ({tokens, labels}, (B, S) each), the
    same on every rank: rank (d, k) embeds and scores rows
    [d m, (d + 1) m) of each of the Q micro-batches, m = B / (Q D).  The
    loss equals the plain model's mean cross entropy, and its gradient
    (``torch.autograd.grad``) the plain gradient of this rank's leaves.
    A collective: every rank of the mesh calls it, and then the loss,
    together.  ``loss.pipe`` tells the transport."""
    _check_config(cfg)
    dev = resolve_device(device)
    pipe = Pipe(mesh, pcfg, dev)
    stage_fn = transformer_stage_fn(cfg)
    S, Q = pcfg.num_stages, pcfg.num_microbatches
    T = Q + S - 1
    first = torch.tensor(pipe.k == 0, device=dev)
    last = torch.tensor(pipe.k == S - 1, device=dev)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        B, L = tokens.shape
        if B % (Q * pipe.D):
            raise ValueError(f"a batch of {B} does not split into {Q} "
                             f"micro-batches over {pipe.D} data ranks")
        m = B // (Q * pipe.D)
        rows = slice(pipe.d * m, (pipe.d + 1) * m)
        tokens = tokens.reshape(Q, B // Q, L)[:, rows]
        labels = labels.reshape(Q, B // Q, L)[:, rows]
        rep = {k: _reduced(pipe, v, True) for k, v in params.items()
               if k != "layers"}
        layers = tree_map(lambda v: _reduced(pipe, v, False),
                          params["layers"])
        x = rep["embed"][tokens.long()].to(cfg.compute_dtype)
        stream = x.float()                          # (Q, m, L, d), f32
        carry = torch.zeros(stream.shape[1:], dtype=cfg.compute_dtype,
                            device=dev)
        outs = []
        for t in range(T):
            x0 = stream[min(t, Q - 1)].to(cfg.compute_dtype)
            y = stage_fn(layers, torch.where(first, x0, carry))
            if t < T - 1:            # the last tick's hop feeds nothing
                carry = _Hop.apply(y, pipe)
            if t >= S - 1:
                outs.append(torch.where(last, y, torch.zeros_like(y)))
        ys = _Combine.apply(torch.stack(outs).float(), pipe)
        ys = ys.to(cfg.compute_dtype)
        part = torch.zeros((), dtype=torch.float32, device=dev)
        heads = range(pipe.k, Q, S)
        for q in heads:
            part = part + cross_entropy(_head_logits(cfg, rep, ys[q]),
                                        labels[q])
        if not heads:
            # Q < S: this rank scores no micro-batch.  Its part still
            # reaches ys and every replicated leaf (with zero gradients),
            # so that its backward runs the combine, the hops and the
            # reductions that the other ranks wait on.
            part = part + 0 * sum(v.sum() for v in (ys, *rep.values()))
        part = part / Q
        with torch.no_grad():
            total = pipe.all_reduce_(part.detach().clone(), pipe.stage_group,
                                     "loss_reduce")
            if pipe.data_group is not None:
                pipe.all_reduce_(total, pipe.data_group,
                                 "loss_reduce").div_(pipe.D)
        # the value of the whole loss, the gradient of this rank's part
        return part + (total - part).detach()

    loss_fn.pipe = pipe
    return loss_fn


def make_pipelined_train_step(cfg: ArchConfig, mesh, pcfg: PipelineConfig,
                              optimizer, device="cuda") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``: the pipelined loss's gradient, then ``optimizer``'s
    update of this rank's tree in place (``opt_state = optimizer.init(
    params)``).  Elementwise optimizers only: Adafactor factors and clips
    whole leaves, and a rank holds a stage's slice of each."""
    if not optimizer.elementwise:
        raise ValueError(f"{optimizer.name} is not elementwise; a stage "
                         "rank holds a slice of each stacked leaf")
    loss_fn = make_pipelined_loss(cfg, mesh, pcfg, device)

    def train_step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        it = iter(torch.autograd.grad(loss, tree_leaves(params)))
        grads = tree_map(lambda _: next(it), params)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach()}

    train_step.pipe = loss_fn.pipe
    return train_step


def plan_to_pipeline_config(stage_plan, global_batch: int) -> PipelineConfig:
    """``core/planner.py::StagePlan`` -> the runtime pipeline config (Q from
    Theorem 1's micro-batch, cut down to a divisor of the batch)."""
    q = max(1, min(stage_plan.num_microbatches, global_batch))
    while global_batch % q:
        q -= 1
    return PipelineConfig(num_stages=stage_plan.num_stages,
                          num_microbatches=q)


__all__ = ["Pipe", "PipelineConfig", "make_pipelined_loss",
           "make_pipelined_train_step", "plan_to_pipeline_config",
           "shard_params"]
