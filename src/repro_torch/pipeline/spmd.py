"""SPMD pipeline parallelism — the paper's pipelined split learning across
devices, on ``torch.distributed``; the port of ``repro/pipeline/spmd.py``.

A mesh of ("data", "stage", "model") ranks (a "pod" axis folds into
data).  Stage k's block of layers lives on the ranks of stage k only: the
local parameter tree of a rank (:func:`shard_params`) holds its stage's
slice of the stacked layers (``stage.py::stack_stage_params``) beside the
embedding, final norm and head, which every rank holds whole (replicated,
outside the pipe, as in the reference).

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
the embedding, the final norm) are whole on each rank.  The head: where
the rules put the vocabulary on "model" (it divides M,
``launch/sharding.py``'s rule for ``embed`` / ``lm_head``) each model rank
computes its block of the logits and the cross entropy is
vocabulary-parallel (the max, the sum of exponentials and each row's gold
logit summed over the group; :func:`_vocab_parallel_ce`); else the head
runs whole on every model rank.

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
from ..launch.sharding import model_block
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
    "grad_reduce", "loss_reduce", "tp_reduce"), ``bytes`` the operand
    bytes this rank put into each; a host-staged transfer's copy to the
    host first waits for the device's queued work."""

    KINDS = ("hop", "hop_back", "combine", "combine_back", "grad_reduce",
             "loss_reduce", "tp_reduce")

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
        dist.all_gather(list(parts.unbind(0)), src, group=group)
        if self.host:
            parts = parts.to(self.device, non_blocking=False)
        out = torch.cat(parts.unbind(0), dim=dim)
        self.seconds[what] += time.perf_counter() - t0
        return out


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


def _check_config(cfg: ArchConfig) -> None:
    """The transformer's families: dense, MoE, and the VLM backbone, whose
    pipelined loss reads the tokens only (as the reference's does: its
    patch embeddings go unused there)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the stage pipeline runs the transformer's layers; "
                         f"family {cfg.family!r} has none")


def _head_logits(cfg: ArchConfig, params: dict, y: torch.Tensor,
                 block=None, pipe: Pipe | None = None):
    """The reference's ``_unembed`` (``Transformer.logits``); with
    ``block`` (:func:`_vocab_block`), this model rank's block of the
    logits, the input's gradient summed over the model group."""
    x = rms_norm(y, params["final_norm"], cfg.norm_eps)
    if block is None:
        head = params["embed"].T if cfg.tie_embeddings else \
            params["lm_head"]
    else:
        x = _ToModel.apply(x, pipe)
        head = block.T if cfg.tie_embeddings else block
    return x @ head.to(x.dtype)


def vocab_parallel(cfg: ArchConfig, M: int) -> bool:
    """Whether the head splits its vocabulary over a model axis of M: the
    reference's rule puts ``embed``'s rows and ``lm_head``'s columns on
    "model" where they divide (``shard_vocab``)."""
    return M > 1 and cfg.vocab % M == 0


def _vocab_block(cfg: ArchConfig, params: dict, pipe: Pipe):
    """This model rank's block of the head: the embedding's rows (tied)
    or ``lm_head``'s columns, its gradient joined over the model group
    (zero outside the block on each rank; the leaf stays whole)."""
    V = cfg.vocab
    blocks = [(r * V // pipe.M, (r + 1) * V // pipe.M)
              for r in range(pipe.M)]
    if cfg.tie_embeddings:
        return _Split.apply(params["embed"], pipe, 0, blocks)
    return _Split.apply(params["lm_head"], pipe, 1, blocks)


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


def shard_params(params: dict, mesh, pcfg: PipelineConfig,
                 device="cuda", *, cfg: ArchConfig | None = None) -> dict:
    """This rank's parameter tree from the reference's whole tree
    (``nest_layers`` of a model's named parameters, or numpy arrays):
    the replicated leaves whole and ``"layers"`` cut to this rank's stage
    and, on a "model" axis of size > 1, to this rank's block of the
    reference's rules (``launch/sharding.py::model_block``; the router
    stays whole, see the module docstring), each a leaf tensor on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``) that
    requires grad.  ``cfg`` is needed with a model axis; a config whose
    attention columns or FFN do not split over it raises ValueError."""
    dev = resolve_device(device)
    M = as_layout(mesh).shape.get("model", 1)
    if M > 1:
        if cfg is None:
            raise ValueError("a model axis needs the config (cfg=) to cut "
                             "the layers by the sharding rules")
        check_model_axis(cfg, M)
    _, _, k, m = _coords(mesh, pcfg)
    S = pcfg.num_stages

    def leaf(x, rows=None):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if rows is not None:
            t = t[rows]
        return t.detach().to(dev).clone().requires_grad_(True)

    def stage_slice(tree, path):
        if isinstance(tree, dict):
            return {name: stage_slice(v, f"{path}/{name}")
                    for name, v in tree.items()}
        L = tree.shape[0]
        if L % S:
            raise ValueError(f"{L} layers do not split into {S} stages")
        name = path.rsplit("/", 1)[-1]
        if M > 1 and name not in _INSIDE:
            tree = model_block(cfg, mesh, path, tree, m)
        n = L // S
        return leaf(tree, slice(k * n, (k + 1) * n))

    return {k: (stage_slice(v, k) if k == "layers" else leaf(v))
            for k, v in params.items()}


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
    (``torch.autograd.grad``) the plain gradient of this rank's leaves.
    A collective: every rank of the mesh calls it, and then the loss,
    together.  ``loss.pipe`` tells the transport."""
    _check_config(cfg)
    check_model_axis(cfg, as_layout(mesh).shape.get("model", 1))
    dev = resolve_device(device)
    pipe = Pipe(mesh, pcfg, dev)
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
        rep = {k: _reduced(pipe, v, True) for k, v in params.items()
               if k != "layers"}
        layers = {k: (_reduced(pipe, v, False, k in inside)
                      if not isinstance(v, dict) else
                      {n: _reduced(pipe, w, False, n in inside)
                       for n, w in v.items()})
                  for k, v in params["layers"].items()}
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
        block = _vocab_block(cfg, rep, pipe) if heads and vocab_split \
            else None
        for q in heads:
            logits = _head_logits(cfg, rep, ys[q], block, pipe)
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
