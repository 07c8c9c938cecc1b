"""SPMD pipeline parallelism — the paper's pipelined split learning across
devices, on ``torch.distributed``; the port of ``repro/pipeline/spmd.py``.

A mesh of ("data", "stage", "model") ranks (a "pod" axis folds into
data).  Stage k's block of layers lives on the ranks of stage k only.  A
rank's parameter tree (:func:`shard_params`) holds each leaf in the
reference's blocks (``launch/sharding.py::param_spec``): its stage's
slice of the stacked layers (``stage.py::stack_stage_params``), each layer
leaf cut further to the rank's FSDP block over the data ranks
(``data_block``) and to its block on "model" (``model_block``); the
embedding's rows to its vocabulary block on "model" (no FSDP block, as the
rule has it), an untied ``lm_head``'s columns to its vocabulary block and
its rows to its FSDP block; the final norm whole.  The reference holds
every stage's layers at 1 / (D M) and gathers them at use; here a rank
holds only its stage's.  AdamW's moments (``opt.init``) take the same
blocks.  A leaf with an FSDP block is gathered whole over the data group,
in the compute dtype, once a step (:class:`_GatherBlock`, "fsdp_gather";
remat's recompute reads the same gathered tensor), its gradient summed
over the ticks that read it in that dtype (as torch's FSDP with a bf16
parameter dtype; the reference sums them in float32) and reduce-scattered
back to the block in float32 ("fsdp_scatter").

A "model" axis of size M > 1 is tensor parallelism inside a stage: each
layer leaf is further cut to the rank's block along the "model" entry of
the reference's rules (``launch/sharding.py::model_block``): 1/M of the
attention's flat query and kv columns and of wo's rows, of the FFN's
columns, and of the experts (or of each expert's columns), so the stage's
layers run Megatron-style column and row blocks (``stage.py::
transformer_stage_fn(cfg, tp=...)``).  Every model rank of a stage holds
the whole activation; a block's input is marked by an identity whose
backward sums the gradient over the model group, its output summed over
the model group (``Pipe.all_reduce_``, "tp_reduce").  Where the heads do
not split into whole heads (``transformer.py::attention_mode``), the
reference's layouts: query heads that split read the kv heads gathered
over the group ("shared_kv"); query heads that do not are gathered whole
on every rank, which attends to its block of the keys' sequence, the
blocks' softmaxes combined over the group ("split_keys",
``kernels/flash/split.py``; the gathers and the combine are "tp_reduce"
too).  The leaves a layer reads whole inside those blocks — the qk-norm
scales of split heads and the MoE router — get a partial gradient on
each model rank, summed over the model group in the backward; the ones
read outside them (the layer norms, the qk-norm scales of gathered heads,
the final norm) are whole on each rank.  The embedding and the head: where
the rules put the vocabulary on "model" (it divides M,
``launch/sharding.py``'s rule for ``embed`` / ``lm_head``) each model rank
looks the tokens up in its row block (ids outside it give zero rows,
summed over the model group: :func:`_embed_rows`), computes its block of
the logits, and the cross entropy is vocabulary-parallel (the max, the sum
of exponentials and each row's gold logit summed over the group;
:func:`_vocab_parallel_ce`); else the table is whole and the head runs
whole on every model rank.

Activations hop stage -> stage + 1 (the paper's inter-server
transmissions, Eqs. 5/6) and their gradients hop back (Eqs. 9/10): a hop
is an ``autograd.Function`` whose forward sends to k + 1 and receives from
k - 1 and whose backward sends the gradient to k - 1 and receives from
k + 1, the send and receive of each tick issued together.

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
cotangents over the stage group; the leaves outside the pipe get their
gradients summed over the stage group, the stage leaves' not; every
gradient is averaged over the data group, reduce-scattered where the leaf
has an FSDP block — inside the backward, so ``torch.autograd.grad(loss,
leaves)`` returns on every rank its block of the whole gradient.  Every
rank builds the same autograd graph, so its backward issues the hops and
reductions in the same order on every rank.

Transport: the process group's backend as the caller set it up.  NCCL
where each rank has a GPU of its own; gloo where ranks share one (NCCL
refuses two ranks on a GPU): gloo moves host memory, so a hop, the
combine, the gathers and the gradient reductions of CUDA tensors go
through pinned host buffers (kept per shape, reused every tick and step),
while all compute stays on the device.  A CPU tensor under gloo moves as
it is.  Under NCCL (and the dry run's fake group, which stands for it)
gathers are ``all_gather_into_tensor`` and the FSDP gradients
``reduce_scatter_tensor``; under gloo a gather of a list and an all-reduce
and a slice.  A failed collective raises; nothing falls back.

Every transfer's host seconds and operand bytes are kept by kind in
``Pipe.seconds`` / ``Pipe.bytes`` (``utils/cost.py`` reads the bytes: no
profiler sees a p2p hop's size).
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
from ..launch.sharding import data_block, data_dim, model_block, model_dim
from ..models.common import ArchConfig, ModelSplit, cross_entropy, rms_norm
from ..utils.treemath import tree_leaves, tree_map
from .stage import transformer_stage_fn


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_stages: int
    num_microbatches: int
    stage_axis: str = "stage"


def _coords(mesh, pcfg: PipelineConfig) -> tuple:
    """(grid, d, k, m): the mesh's global ranks as a (D, S, M) grid (the
    data axes major, then stage, the model axis minor) and this rank's
    data row d, stage k and model index m in it."""
    lay = as_layout(mesh)
    ax = pcfg.stage_axis
    known = ("pod", "data", ax, "model")
    if ax not in lay.axis_names:
        raise ValueError(f"the mesh {lay.axis_names} has no {ax!r} axis")
    for a in lay.axis_names:
        if a not in known:
            raise ValueError(f"mesh axis {a!r} is none of {known}")
    if lay.shape[ax] != pcfg.num_stages:
        raise ValueError(f"the mesh's {ax!r} axis has {lay.shape[ax]} "
                         f"ranks, the pipeline {pcfg.num_stages} stages")
    ranks = np.asarray(mesh.mesh.tolist()) if hasattr(mesh, "mesh") else \
        np.arange(lay.size).reshape(lay.sizes)
    names = lay.axis_names
    tail = [names.index(ax)] + ([names.index("model")] if "model" in names
                                else [])
    order = [i for i in range(len(names)) if i not in tail] + tail
    M = lay.shape.get("model", 1)
    grid = ranks.transpose(order).reshape(-1, pcfg.num_stages, M)
    me = dist.get_rank()
    where = np.argwhere(grid == me)
    if len(where) != 1:
        raise ValueError(f"rank {me} is not in the mesh {grid.tolist()}")
    return grid, int(where[0][0]), int(where[0][1]), int(where[0][2])


class Pipe:
    """This rank's place in the mesh: its stage k of S, its data index d of
    D, its model index m of M, the process groups of its stage row, its
    data column and its model group (every rank creates every group, in
    the same order: a collective), its neighbours' global ranks, and how
    tensors move (``transport``: "direct", or "host-staged" for CUDA
    tensors under gloo).  ``seconds`` adds up the host's time in each kind
    of transfer ("hop", "hop_back", "combine", "combine_back",
    "grad_reduce", "loss_reduce", "tp_reduce", "fsdp_gather",
    "fsdp_scatter"), ``bytes`` the operand bytes this rank put into each;
    a host-staged transfer's copy to the host first waits for the
    device's queued work."""

    KINDS = ("hop", "hop_back", "combine", "combine_back", "grad_reduce",
             "loss_reduce", "tp_reduce", "fsdp_gather", "fsdp_scatter")

    def __init__(self, mesh, pcfg: PipelineConfig, device):
        grid, self.d, self.k, self.m = _coords(mesh, pcfg)
        self.device = device
        self.D, self.S, self.M = grid.shape

        def groups(lines):
            return [dist.new_group([int(r) for r in line]) for line in lines]

        rows = groups(grid[d, :, m] for d in range(self.D)
                      for m in range(self.M))
        cols = groups(grid[:, k, m] for k in range(self.S)
                      for m in range(self.M))
        models = groups(grid[d, k, :] for d in range(self.D)
                        for k in range(self.S)) if self.M > 1 else None
        self.stage_group = rows[self.d * self.M + self.m]
        self.data_group = cols[self.k * self.M + self.m] if self.D > 1 \
            else None
        self.model_group = models[self.d * self.S + self.k] if models \
            else None
        self.prev = int(grid[self.d, self.k - 1, self.m]) if self.k > 0 \
            else None
        self.next = int(grid[self.d, self.k + 1, self.m]) \
            if self.k < self.S - 1 else None
        self.backend = dist.get_backend(self.stage_group)
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors; pass device='cuda'")
        # a fake process group (the dry run) moves nothing: it stands for
        # NCCL's direct transfers
        self.host = self.backend not in ("nccl", "fake") \
            and device.type == "cuda"
        # NCCL's gathers and reduce-scatters into one tensor; gloo's of a
        # list, and an all-reduce and a slice
        self.fused = self.backend in ("nccl", "fake")
        self.transport = "host-staged" if self.host else "direct"
        self.seconds = dict.fromkeys(self.KINDS, 0.0)
        self.bytes = dict.fromkeys(self.KINDS, 0)
        self._buffers = {}

    def _buffer(self, role: str, like: torch.Tensor) -> torch.Tensor:
        """A host buffer shaped like ``like`` for one role ("send",
        "recv", "reduce", "gather"), pinned for a CUDA device; every
        transfer waits for its own completion, so the next one may reuse
        it."""
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
            self.bytes[what] += send.numel() * send.element_size()
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

    def all_reduce_(self, t: torch.Tensor, group, what: str,
                    op: str = "sum") -> torch.Tensor:
        """Sum (or with ``op`` "max", max) ``t`` over ``group`` in place
        (None: a group of one)."""
        if group is None or dist.get_world_size(group) == 1:
            return t
        t0 = time.perf_counter()
        self.bytes[what] += t.numel() * t.element_size()
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self.host:
            h = self._buffer("reduce", t).copy_(t.detach())
            dist.all_reduce(h, op=rop, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=rop, group=group)
        self.seconds[what] += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor, group, what: str,
                   dim: int) -> torch.Tensor:
        """The group's equal blocks ``t`` joined along ``dim``, in the
        group's rank order: gathered into one (n, ...) buffer (pinned and
        kept per shape when host-staged), joined on the device."""
        t0 = time.perf_counter()
        self.bytes[what] += t.numel() * t.element_size()
        n = dist.get_world_size(group)
        src = t.detach().contiguous()
        like = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                           device="meta")
        if self.host:
            src = self._buffer("send", src).copy_(src)
            parts = self._buffer("gather", like)
        else:
            parts = torch.empty(like.shape, dtype=src.dtype,
                                device=src.device)
        if self.fused:
            _all_gather_into(parts, src, group=group)
        else:
            dist.all_gather(list(parts.unbind(0)), src, group=group)
        if self.host:
            parts = parts.to(self.device, non_blocking=False)
        out = torch.cat(parts.unbind(0), dim=dim)
        self.seconds[what] += time.perf_counter() - t0
        return out

    def reduce_scatter(self, t: torch.Tensor, group,
                       what: str) -> torch.Tensor:
        """This rank's block (its index in ``group``) of the sum of ``t``
        over ``group``, ``t`` cut into the group's number of equal blocks
        along dim 0: ``reduce_scatter_tensor``, or (gloo) an all-reduce of
        ``t`` in place, host-staged for a CUDA tensor, and this rank's
        slice of it."""
        t0 = time.perf_counter()
        self.bytes[what] += t.numel() * t.element_size()
        n = dist.get_world_size(group)
        w = t.shape[0] // n
        if self.fused:
            out = torch.empty((w,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            _reduce_scatter_into(out, t.contiguous(), group=group)
        else:
            i = dist.get_rank(group)
            if self.host:
                h = self._buffer("reduce", t).copy_(t)
                dist.all_reduce(h, group=group)
                out = h[i * w:(i + 1) * w].to(self.device, copy=True)
            else:
                dist.all_reduce(t, group=group)
                out = t[i * w:(i + 1) * w]
        self.seconds[what] += time.perf_counter() - t0
        return out


def _all_gather_into(out, t, group):
    """``all_gather_into_tensor`` by the name this torch gives it."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, t, group=group)


def _reduce_scatter_into(out, t, group):
    """``reduce_scatter_tensor`` by the name this torch gives it."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, t, group=group)


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


class _ToModel(torch.autograd.Function):
    """The input of a column-parallel block: identity forward, the
    gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.pipe.all_reduce_(g.clone(), ctx.pipe.model_group,
                                    "tp_reduce"), None


class _FromModel(torch.autograd.Function):
    """The output of a row-parallel block: summed over the model group,
    identity backward."""

    @staticmethod
    def forward(ctx, x, pipe):
        return pipe.all_reduce_(x.clone(), pipe.model_group, "tp_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The model group's equal blocks joined along ``dim``; backward this
    rank's block of the gradient (the whole one, the same on every
    rank)."""

    @staticmethod
    def forward(ctx, x, pipe, dim):
        ctx.m, ctx.n, ctx.dim = pipe.m, x.shape[dim], dim
        return pipe.all_gather(x, pipe.model_group, "tp_reduce", dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.m * ctx.n, ctx.n), None, None


class _Split(torch.autograd.Function):
    """This rank's block (lo, hi) of a whole tensor along ``dim`` (blocks
    that may be uneven or empty); backward the blocks' gradients joined
    (gathered padded to the largest block)."""

    @staticmethod
    def forward(ctx, x, pipe, dim, blocks):
        ctx.pipe, ctx.dim, ctx.blocks = pipe, dim, blocks
        lo, hi = blocks[pipe.m]
        return x.narrow(dim, lo, hi - lo)

    @staticmethod
    def backward(ctx, g):
        dim, blocks = ctx.dim % g.dim(), ctx.blocks
        width = max(hi - lo for lo, hi in blocks)
        pad = [0, 0] * (g.dim() - 1 - dim) + [0, width - g.shape[dim]]
        whole = ctx.pipe.all_gather(torch.nn.functional.pad(g, pad),
                                    ctx.pipe.model_group, "tp_reduce", dim)
        parts = [whole.narrow(dim, i * width, hi - lo)
                 for i, (lo, hi) in enumerate(blocks)]
        return torch.cat(parts, dim=dim), None, None, None


def model_split(pipe: Pipe) -> ModelSplit:
    """The layers' :class:`ModelSplit` on this rank's model group."""
    return ModelSplit(
        pipe.M, pipe.m,
        enter=lambda x: _ToModel.apply(x, pipe),
        exit=lambda x: _FromModel.apply(x, pipe),
        gather=lambda x, dim: _Gather.apply(x, pipe, dim),
        split=lambda x, dim, blocks: _Split.apply(x, pipe, dim, blocks),
        reduce=lambda t, op: pipe.all_reduce_(t, pipe.model_group,
                                              "tp_reduce", op))


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (``over_model``: a leaf read whole inside the column / row
    blocks), over the stage group (``over_stage``: a replicated leaf) and
    averages it over the data group."""

    @staticmethod
    def forward(ctx, x, pipe, over_stage, over_model):
        ctx.pipe, ctx.over_stage, ctx.over_model = pipe, over_stage, \
            over_model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        g = g.clone()
        if ctx.over_model:
            pipe.all_reduce_(g, pipe.model_group, "grad_reduce")
        if ctx.over_stage:
            pipe.all_reduce_(g, pipe.stage_group, "grad_reduce")
        if pipe.data_group is not None:
            pipe.all_reduce_(g, pipe.data_group, "grad_reduce").div_(pipe.D)
        return g, None, None, None


class _GatherBlock(torch.autograd.Function):
    """A leaf's FSDP block gathered whole over the data group along
    ``dim``, in ``dtype``.  Backward: the whole gradient (summed over the
    uses in ``dtype``) in the block's type, reduce-scattered over the data
    group back to the block and averaged over it, then summed over the
    stage group (``over_stage``: a leaf outside the pipe)."""

    @staticmethod
    def forward(ctx, x, pipe, dim, dtype, over_stage):
        ctx.pipe, ctx.dim, ctx.dtype, ctx.over_stage = pipe, dim, x.dtype, \
            over_stage
        return pipe.all_gather(x.detach().to(dtype), pipe.data_group,
                               "fsdp_gather", dim)

    @staticmethod
    def backward(ctx, g):
        pipe, dim = ctx.pipe, ctx.dim
        moved = g.movedim(dim, 0)
        whole = torch.empty(moved.shape, dtype=ctx.dtype,
                            device=g.device).copy_(moved)
        del g, moved
        block = pipe.reduce_scatter(whole, pipe.data_group, "fsdp_scatter")
        block = block.movedim(0, dim).contiguous().div_(pipe.D)
        if ctx.over_stage:
            pipe.all_reduce_(block, pipe.stage_group, "grad_reduce")
        return block, None, None, None, None


#: layer leaves read whole inside the model-parallel blocks (their
#: gradient on one model rank is that rank's heads' or experts' part)
_INSIDE = ("q_norm", "k_norm", "router")


def _inside(cfg: ArchConfig, M: int) -> tuple:
    """:data:`_INSIDE` for ``cfg`` on a model axis of M: the qk-norm
    scales are read on whole gathered heads where the query heads do not
    split (``transformer.py::attention_mode`` "split_keys"; their gradient
    whole on each rank, as the layer norms')."""
    from ..models import transformer as tf_lib
    if tf_lib.attention_mode(cfg, M) == "split_keys":
        return tuple(n for n in _INSIDE if n not in ("q_norm", "k_norm"))
    return _INSIDE


def _reduced(pipe: Pipe, x: torch.Tensor, over_stage: bool,
             over_model: bool = False):
    over_model = over_model and pipe.M > 1
    if not x.requires_grad or (pipe.data_group is None and not over_model
                               and (not over_stage or pipe.S == 1)):
        return x
    return _ReduceGrad.apply(x, pipe, over_stage, over_model)


def _as_read(pipe: Pipe, x: torch.Tensor, dim, dtype, over_stage: bool,
             over_model: bool = False):
    """The leaf ``x`` as the step reads it: gathered whole over the data
    group where it holds an FSDP block along ``dim``
    (:class:`_GatherBlock`), else itself with its gradient reduced
    (:func:`_reduced`)."""
    if dim is None:
        return _reduced(pipe, x, over_stage, over_model)
    return _GatherBlock.apply(x, pipe, dim, dtype, over_stage)


def _check_config(cfg: ArchConfig) -> None:
    """The transformer's families: dense, MoE, and the VLM backbone, whose
    pipelined loss reads the tokens only (as the reference's does: its
    patch embeddings go unused there)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the stage pipeline runs the transformer's layers; "
                         f"family {cfg.family!r} has none")


def _head_logits(cfg: ArchConfig, params: dict, y: torch.Tensor,
                 pipe: Pipe, vocab_split: bool):
    """The reference's ``_unembed`` (``Transformer.logits``) from the head
    as the step reads it (the tied embedding's rows or ``lm_head``); with
    ``vocab_split``, from this model rank's vocabulary block of it: this
    rank's block of the logits, the input's gradient summed over the
    model group."""
    x = rms_norm(y, params["final_norm"], cfg.norm_eps)
    if vocab_split:
        x = _ToModel.apply(x, pipe)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def vocab_parallel(cfg: ArchConfig, M: int) -> bool:
    """Whether the head splits its vocabulary over a model axis of M: the
    reference's rule puts ``embed``'s rows and ``lm_head``'s columns on
    "model" where they divide (``shard_vocab``)."""
    return M > 1 and cfg.vocab % M == 0


def _embed_rows(block: torch.Tensor, tokens: torch.Tensor,
                pipe: Pipe) -> torch.Tensor:
    """The embedding of ``tokens`` from this model rank's vocabulary block
    of the table (rows [m n, (m + 1) n)): ids outside the block give zero
    rows, summed over the model group, so every rank holds the whole
    embedding and each row's gradient stays on the rank that holds it."""
    n = block.shape[0]
    idx = tokens.long() - pipe.m * n
    mine = (idx >= 0) & (idx < n)
    rows = block[idx.clamp(0, n - 1)]
    return _FromModel.apply(torch.where(mine[..., None], rows, 0.0), pipe)


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                       pipe: Pipe, ignore_id: int = -1) -> torch.Tensor:
    """``models/common.py::cross_entropy`` of logits whose vocabulary is
    split over the model group, each rank holding its block (B, S, V / M)
    of it: the max (no gradient) and the sum of exponentials over the
    group, each row's gold logit from the rank whose block holds its
    label (0 from the others), summed over the group; labels equal to
    ``ignore_id`` left out."""
    n = logits.shape[-1]
    mx = pipe.all_reduce_(logits.detach().amax(dim=-1, keepdim=True),
                          pipe.model_group, "tp_reduce", "max")
    shifted = logits - mx
    sumexp = _FromModel.apply(
        torch.exp(shifted).sum(dim=-1, dtype=torch.float32), pipe)
    idx = labels.long() - pipe.m * n
    mine = (idx >= 0) & (idx < n)
    gold = torch.gather(shifted, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = _FromModel.apply(torch.where(mine, gold.float(), 0.0), pipe)
    nll = torch.log(sumexp) - gold
    mask = labels != ignore_id
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def check_model_axis(cfg: ArchConfig, M: int) -> None:
    """ValueError unless a model axis of M splits ``cfg``'s layers into
    equal blocks: the attention's flat query and kv columns (whole heads
    or not, :func:`~repro_torch.models.transformer.attention_mode`) and
    the FFN's columns (or the experts)."""
    if M == 1:
        return
    from ..models import moe as moe_lib
    from ..models import transformer as tf_lib
    split = ModelSplit(M)
    tf_lib.TransformerLayer(cfg, device="meta", split=split)
    if cfg.moe_experts and not moe_lib.expert_parallel(cfg, split):
        split.part(cfg.d_ff, "expert FFN columns")


def _data_size(mesh) -> int:
    lay = as_layout(mesh)
    return lay.shape.get("pod", 1) * lay.shape.get("data", 1)


def block_dims(cfg: ArchConfig, mesh, path: str, shape: tuple) -> tuple:
    """(the model dim, the data dim) of the leaf at ``path`` (of whole
    shape ``shape``) that :func:`shard_params` cuts into the rank's block
    over the "model" axis and over the data ranks (FSDP), each None where
    it is whole: the rules' entries (``launch/sharding.py::model_dim`` /
    ``data_dim``), none on an axis of one rank, and no model block for
    the leaves read whole inside the model blocks (:data:`_INSIDE`)."""
    lay = as_layout(mesh)
    name = path.rsplit("/", 1)[-1]
    md = model_dim(cfg, mesh, path, shape) \
        if lay.shape.get("model", 1) > 1 and name not in _INSIDE else None
    dd = data_dim(cfg, mesh, path, shape) if _data_size(mesh) > 1 else None
    return md, dd


def _leaf_shapes(cfg: ArchConfig) -> dict:
    """{tree path: whole shape} of ``cfg``'s parameter tree."""
    from ..configs import param_specs

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield prefix + k, tuple(v.shape)
    return dict(walk(param_specs(cfg), ""))


def shard_params(params: dict, mesh, pcfg: PipelineConfig,
                 device="cuda", *, cfg: ArchConfig | None = None) -> dict:
    """This rank's parameter tree from the reference's whole tree
    (``nest_layers`` of a model's named parameters, or numpy arrays), in
    the reference's nested layout with each leaf the rank's block (see
    the module docstring): ``"layers"`` cut to this rank's stage, every
    leaf to its FSDP block over the data ranks (``launch/sharding.py::
    data_block``) and, on a "model" axis of size > 1, to its block on
    "model" (``model_block``; the router stays whole), where the
    reference's rules split it (:func:`block_dims`).  Each is a leaf
    tensor on ``device`` (``"cuda"`` unless the caller passes ``"cpu"``)
    that requires grad.  ``cfg`` is needed with a data or a model axis; a
    config whose attention columns or FFN do not split over the model
    axis raises ValueError."""
    dev = resolve_device(device)
    M = as_layout(mesh).shape.get("model", 1)
    if (M > 1 or _data_size(mesh) > 1) and cfg is None:
        raise ValueError("a data or a model axis needs the config (cfg=) "
                         "to cut the leaves by the sharding rules")
    if M > 1:
        check_model_axis(cfg, M)
    _, d, k, m = _coords(mesh, pcfg)
    S = pcfg.num_stages

    def leaf(x, path):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        md, dd = block_dims(cfg, mesh, path, tuple(t.shape))
        # the data block first: the model dim of the cut leaf is the
        # whole one's (the rules' data and model dims differ, and a dim
        # a data block makes divisible by M was divisible before)
        if dd is not None:
            t = data_block(cfg, mesh, path, t, d)
        if md is not None:
            t = model_block(cfg, mesh, path, t, m)
        if path.startswith("layers/"):
            L = t.shape[0]
            if L % S:
                raise ValueError(f"{L} layers do not split into {S} stages")
            t = t[k * (L // S):(k + 1) * (L // S)]
        return t.detach().to(dev).clone().requires_grad_(True)

    def walk(tree, prefix):
        return {name: (walk(v, f"{prefix}{name}/") if isinstance(v, dict)
                       else leaf(v, prefix + name))
                for name, v in tree.items()}

    return walk(params, "")


def param_shardings(params: dict, mesh, pcfg: PipelineConfig, *,
                    cfg: ArchConfig | None = None) -> dict:
    """The blocks :func:`shard_params` cuts from the whole tree ``params``
    (tensors or arrays of the whole shapes), as a tree of
    ``launch/sharding.py::NamedSharding`` on ``mesh`` (a ``DeviceMesh``):
    a layer leaf's dim 0 over the stage axis, its model and data dims
    (:func:`block_dims`) over "model" and the data axes, so each rank's
    block of a leaf under DTensor's placements is its :func:`shard_params`
    leaf.  With ``sharding.py::opt_sharding_tree`` the AdamW state's too:
    ``checkpoint/store.py`` saves a rank's tree as DTensors
    (:func:`as_dtensors`) and restores it onto another mesh."""
    from ..launch.sharding import NamedSharding, param_spec

    def spec(path, shape):
        md, dd = block_dims(cfg, mesh, path, shape)
        out = [None] * len(shape)
        if path.startswith("layers/"):
            out[0] = pcfg.stage_axis
        if md is not None:
            out[md] = "model"
        if dd is not None:
            out[dd] = param_spec(cfg, mesh, path, shape)[dd]
        return NamedSharding(mesh, tuple(out))

    def walk(tree, prefix):
        return {name: (walk(v, f"{prefix}{name}/") if isinstance(v, dict)
                       else spec(prefix + name, tuple(v.shape)))
                for name, v in tree.items()}

    return walk(params, "")


def as_dtensors(local, shardings):
    """Each block of the tree ``local`` (a rank's :func:`shard_params`
    tree, or its optimizer state) as the DTensor it is a block of, under
    the matching ``NamedSharding`` of ``shardings``: what
    ``checkpoint/store.py::save_checkpoint`` gathers and writes whole."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t, sh: DTensor.from_local(
        t.detach(), sh.mesh, sh.placements(), run_check=False),
        local, shardings)


def _data_rows(tokens, labels, Q: int, pipe: Pipe) -> tuple:
    """This data rank's rows of each of the Q micro-batches of (B, L)
    ``tokens`` / ``labels``: (Q, m, L) each, m = ceil(B / (Q D)), and the
    weight of its mean loss.  A micro-batch's B / Q rows split over the D
    data ranks as far as they go, padded to m D (the reference's layout of
    a stream whose rows do not divide): a rank's padding rows are token 0
    with label -1, which the cross entropy leaves out, so they add nothing
    to the loss or the gradients.  The weight, (its real rows) D / (B /
    Q), makes the data group's mean of the ranks' means the mean over the
    real rows (1 where the rows divide)."""
    B, L = tokens.shape
    r = B // Q
    m = -(-r // pipe.D)
    lo, hi = min(pipe.d * m, r), min((pipe.d + 1) * m, r)
    tokens = tokens.reshape(Q, r, L)[:, lo:hi]
    labels = labels.reshape(Q, r, L)[:, lo:hi]
    if hi - lo < m:
        pad = (0, 0, 0, m - (hi - lo))
        tokens = torch.nn.functional.pad(tokens, pad, value=0)
        labels = torch.nn.functional.pad(labels, pad, value=-1)
    weight = 1 if (hi - lo) * pipe.D == r else (hi - lo) * pipe.D / r
    return tokens, labels, weight


def make_pipelined_loss(cfg: ArchConfig, mesh, pcfg: PipelineConfig,
                        device="cuda") -> Callable:
    """Returns ``loss(params, batch)`` running the layers through the stage
    pipeline, on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``).  ``params`` is this rank's tree (:func:`shard_params`);
    ``batch`` the whole global batch ({tokens, labels}, (B, S) each), the
    same on every rank: rank (d, k) embeds and scores rows
    [d m, (d + 1) m) of each of the Q micro-batches, m = B / (Q D) (a
    micro-batch with fewer rows than the D data ranks padded, see
    :func:`_data_rows`).  The
    loss equals the plain model's mean cross entropy, and its gradient
    (``torch.autograd.grad``) this rank's block of the plain gradient of
    each leaf.
    A collective: every rank of the mesh calls it, and then the loss,
    together.  ``loss.pipe`` tells the transport."""
    _check_config(cfg)
    check_model_axis(cfg, as_layout(mesh).shape.get("model", 1))
    dev = resolve_device(device)
    pipe = Pipe(mesh, pcfg, dev)
    dims = {path: block_dims(cfg, mesh, path, shape)[1]
            for path, shape in _leaf_shapes(cfg).items()}
    stage_fn = transformer_stage_fn(cfg, model_split(pipe))
    inside = _inside(cfg, pipe.M)
    vocab_split = vocab_parallel(cfg, pipe.M)
    S, Q = pcfg.num_stages, pcfg.num_microbatches
    T = Q + S - 1
    first = torch.tensor(pipe.k == 0, device=dev)
    last = torch.tensor(pipe.k == S - 1, device=dev)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        B, L = tokens.shape
        if B % Q:
            raise ValueError(f"a batch of {B} does not split into {Q} "
                             f"micro-batches")
        tokens, labels, weight = _data_rows(tokens, labels, Q, pipe)

        def read(tree, prefix, over_stage):
            return {k: (read(v, f"{prefix}{k}/", over_stage)
                        if isinstance(v, dict) else
                        _as_read(pipe, v, dims[prefix + k],
                                 cfg.compute_dtype, over_stage, k in inside))
                    for k, v in tree.items()}

        rep = read({k: v for k, v in params.items() if k != "layers"}, "",
                   True)
        layers = read(params["layers"], "layers/", False)
        x = _embed_rows(rep["embed"], tokens, pipe) if vocab_split else \
            rep["embed"][tokens.long()]
        x = x.to(cfg.compute_dtype)
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
            logits = _head_logits(cfg, rep, ys[q], pipe, vocab_split)
            ce = _vocab_parallel_ce(logits, labels[q], pipe) if vocab_split \
                else cross_entropy(logits, labels[q])
            part = part + (ce if weight == 1 else ce * weight)
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
    params)``: the moments in the leaves' blocks).  Elementwise optimizers
    only: Adafactor factors and clips whole leaves, and a rank holds a
    block of each."""
    if not optimizer.elementwise:
        raise ValueError(f"{optimizer.name} is not elementwise; a stage "
                         "rank holds a block of each leaf")
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


__all__ = ["Pipe", "PipelineConfig", "as_dtensors", "block_dims",
           "make_pipelined_loss", "make_pipelined_train_step",
           "param_shardings", "plan_to_pipeline_config", "shard_params"]
