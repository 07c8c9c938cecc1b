"""Shared model pieces — the port of ``repro/models/common.py``: the
architecture config, the initializers, ``rms_norm``, ``layer_norm``,
``gelu_mlp``, RoPE, ``decode_attention``, ``chunked_linear_scan``,
``cross_entropy``, ``remat_wrap`` and the cache of compute-type casts that
the language models keep.

The reference's ``full_attention`` and ``chunked_attention`` (with their
causal mask and sliding window) have one counterpart here: attention over a
whole sequence (a prefill, a training step, Whisper's encoder and its
cross-attention) goes through ``kernels/flash::flash_attention`` (K2, and
K2' for its gradient).

:func:`nest_layers` and :func:`lookup` carry a model's named tensors
(``layers.<i>.<name>``, ``periods.<i>.<name>``, ``enc_layers.<i>.<name>``,
...) to and from the reference's layout, where each such tensor is stacked
over its group on a leading axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The fields of the reference's config that the families (``ssm``:
    RWKV6; ``dense``: the decoder-only transformer, with its QKV biases,
    GELU MLP, untied head and sliding window; ``moe``: the same with a
    mixture-of-experts FFN; ``vlm``: the transformer with patch embeddings
    prepended; ``hybrid``: Jamba's Mamba and attention layers; ``audio``:
    the Whisper encoder-decoder) read, under the reference's names and
    with its defaults.  The reference's ``rwkv`` flag is the family
    ``ssm`` here, and its ``use_pallas`` switch has no counterpart: in the
    port the tensor's device picks the route (the kernel on CUDA, its
    plain version on the CPU)."""
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int
    n_kv: int
    d_head: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False   # declared, never read (as the reference)
    tie_embeddings: bool = False
    ffn_mult: int = 3             # 3 = SwiGLU, 2 = plain GELU MLP
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1            # see is_moe_layer
    capacity_factor: float = 1.25
    moe_ff_chunks: int = 1        # the expert FFN in this many ff slices
    # hybrid (Jamba): within a period of ``attn_every`` layers, one
    # attention layer (the last), the rest Mamba; 0: attention only
    attn_every: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    # enc-dec (Whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # vlm
    patch_tokens: int = 0         # stub ViT patch embeddings, prepended
    use_rope: bool = True
    rope_theta: float = 1e6
    attn_chunk: int = 1024        # the reference's full/chunked switch;
    #                               the port's K2 takes every length
    sliding_window: int = 0       # >0: attention window
    rwkv_head_dim: int = 64
    norm_eps: float = 1e-6
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    scan_chunk: int = 256         # time-chunk of the RWKV / Mamba scans
    remat: str = "layer"          # none | layer | dots (see remat_wrap)
    train_microbatches: int = 0   # 0 = auto (launch/steps.py policy)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv

    def layer_kind(self, i: int) -> str:
        """'rwkv' | 'attn' | 'mamba' for layer i (of a hybrid stack: the
        last of each period of ``attn_every`` layers is attention)."""
        if self.family == "ssm":
            return "rwkv"
        if self.attn_every <= 0:
            return "attn"
        return "attn" if (i % self.attn_every) == (self.attn_every - 1) \
            else "mamba"

    def is_moe_layer(self, i: int) -> bool:
        """The reference's test, which its profile reads; its model (and
        the port's) puts experts in every layer once ``moe_experts`` > 0,
        whatever ``moe_every`` says (ROADMAP Queue 3)."""
        return self.moe_experts > 0 and \
            (i % self.moe_every) == (self.moe_every - 1)


def _identity(x):
    return x


def _whole(x, dim, blocks=None):
    return x


def _no_reduce(t, op):
    return t


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """This rank's block of a layer along a mesh's "model" axis
    (Megatron-style tensor parallelism inside a pipeline stage): ``size``
    ranks, this one ``rank``.  A layer built with a split holds 1/size of
    its attention's flat query and kv columns (whole heads where they
    divide) and of its FFN's hidden width (or of its experts, see
    ``models/moe.py``); ``enter`` marks the input of each column-parallel
    block (identity forward, the gradient summed over the model group)
    and ``exit`` the output of each row-parallel one (summed over the
    model group forward, identity backward).  Where the attention's heads
    do not split (``transformer.py::attention_mode``): ``gather(x, dim)``
    joins the group's equal blocks of ``x`` along ``dim`` (backward: this
    rank's block of the whole gradient), ``split(x, dim, blocks)`` keeps
    this rank's block ``blocks[rank]`` = (lo, hi) of a whole ``x`` along
    ``dim`` (backward: the blocks' gradients joined), and ``reduce(t,
    op)`` sums ("sum") or maxes ("max") a tensor over the group, outside
    autograd (``kernels/flash/split.py``'s combine).  The default is the
    whole layer."""
    size: int = 1
    rank: int = 0
    enter: Callable = _identity
    exit: Callable = _identity
    gather: Callable = _whole
    split: Callable = _whole
    reduce: Callable = _no_reduce

    def part(self, n: int, what: str) -> int:
        """n / size, or ValueError when size does not divide n."""
        if n % self.size:
            raise ValueError(f"{n} {what} do not split over a model axis of "
                             f"{self.size}")
        return n // self.size


WHOLE = ModelSplit()


#: a spec entry for the batch dim: the mesh's data axes, as the
#: reference's ("pod", "data")
DATA = ("pod", "data")


def model_axis_size(x) -> int:
    """The size of the "model" axis of a DTensor's mesh (1 without one, or
    for a plain tensor)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return 1
    names = x.device_mesh.mesh_dim_names or ()
    return x.device_mesh.size(names.index("model")) if "model" in names \
        else 1


def _stationary_mode():
    """The active :class:`_WeightStationary` mode, or None."""
    from torch.overrides import _get_current_function_mode_stack
    for mode in reversed(_get_current_function_mode_stack()):
        if isinstance(mode, _WeightStationary):
            return mode
    return None


class _WeightStationary(torch.overrides.TorchFunctionMode):
    """Products of activations replicated over some data axes (``axes``)
    with a 2-D parameter block, laid out as XLA lays them: over each such
    axis the parameter stays split (FSDP's block, see
    :func:`gather_data_axes`) and the activations are cut to the matching
    slice of the contracted dim, each rank summing a partial product; a
    parameter split there along its output dim already splits the product,
    and one replicated there is cut along its input dim.  The slices are
    taken before the product, so its backward (the weight's gradient
    among it) runs on them too: DTensor's planner weighs communication
    only, and would run those products whole on every rank."""

    _MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    def __init__(self, axes: frozenset):
        super().__init__()
        self.axes = axes

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._MATMULS and len(args) == 2 and not kwargs:
            y = self._product(*args)
            if y is not None:
                return y
        return func(*args, **kwargs)

    def _product(self, x, w):
        """``x @ w`` laid out as the class says, or None where nothing
        changes (a plain operand, a weight of another rank than 2)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not (isinstance(x, DTensor) and isinstance(w, DTensor)
                and w.dim() == 2 and x.device_mesh == w.device_mesh):
            return None
        mesh = x.device_mesh
        names = mesh.mesh_dim_names or ()
        lead = x.shape[:-1]
        if x.dim() != 2:
            # flatten the rows first: DTensor's planner takes the
            # flattened view of a sliced 3-D tensor for a strided layout,
            # whose plans it searches slowly
            x = x.reshape(-1, x.shape[-1])
        xp, wp = list(x.placements), list(w.placements)
        for i, name in enumerate(names):
            if name in self.axes and xp[i] == Replicate() \
                    and not (wp[i].is_shard(1) or wp[i].is_partial()) \
                    and w.shape[0] % mesh.size(i) == 0:
                xp[i], wp[i] = Shard(1), Shard(0)
        if tuple(xp) != tuple(x.placements):
            x = x.redistribute(mesh, tuple(xp))
        if tuple(wp) != tuple(w.placements):
            w = w.redistribute(mesh, tuple(wp))
        y = torch.mm(x, w)
        # its gradient as the product left it, the partial sums summed (a
        # layout DTensor chose for the gradient, rows split or strided,
        # would send the weight's gradient product on a slow plan search)
        y = _Constrain.apply(y, tuple(y.placements))
        return y.reshape(*lead, w.shape[1])


@contextlib.contextmanager
def batch_layout(rows):
    """The products of the block laid out for a batch as small as
    ``rows`` (a DTensor whose dim 0 holds the step's batch rows, e.g. a
    micro-batch's tokens): over each mesh axis other than "model" and
    "stage" that the rows are not split over (the reference's hints drop
    the batch's entry where its rows do not divide, so the activations
    are replicated there), :class:`_WeightStationary` splits the products
    as XLA does, and :func:`gather_data_axes` leaves the parameters' FSDP
    blocks in place.  Rows split over every data axis, or a plain
    ``rows``: nothing changes.  The dry run enters it around a whole
    step; a remat recompute, which runs outside it, re-enters it
    (``remat_wrap``)."""
    from torch.distributed.tensor import DTensor
    axes = frozenset()
    if isinstance(rows, DTensor):
        names = rows.device_mesh.mesh_dim_names or ()
        axes = frozenset(n for n, pl in zip(names, rows.placements)
                         if n not in ("model", "stage")
                         and not pl.is_shard(0))
    if not axes:
        yield
        return
    with _WeightStationary(axes):
        yield


def gather_data_axes(p, stationary: bool = False):
    """A DTensor parameter made whole over every mesh axis but "model"
    before use (FSDP's all-gather: the rules shard d_model over the data
    axes for storage only) — but a matrix, or a ``stationary`` parameter
    whose products the caller lays out itself (the MoE's experts,
    ``models/moe.py``), left split over the axes where
    :func:`batch_layout` keeps it in place (the products
    :class:`_WeightStationary` lays out); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(p, DTensor):
        return p
    names = p.device_mesh.mesh_dim_names or ()
    mode = _stationary_mode()
    keep = ("model",) + (tuple(mode.axes) if mode is not None
                         and (p.dim() == 2 or stationary) else ())
    place = tuple(pl if i < len(names) and names[i] in keep
                  else Replicate() for i, pl in enumerate(p.placements))
    return p if place == tuple(p.placements) else \
        p.redistribute(p.device_mesh, place)


def mesh_zeros(spec: torch.Tensor, like):
    """A zeroed cache entry of ``spec``'s shape and type (a leading layer
    axis before the dims of one layer's slot) for a slot written with
    ``like``: on ``like``'s mesh, each of its splits one dim further
    (the dry run's sharded prefill, whose cache a plain tensor cannot
    take), or a plain tensor on ``like``'s device."""
    from torch.distributed.tensor import DTensor, Shard, zeros
    if not isinstance(like, DTensor):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=like.device)
    place = [Shard(p.dim + 1) if p.is_shard() else p
             for p in like.placements]
    return zeros(tuple(spec.shape), dtype=spec.dtype,
                 device_mesh=like.device_mesh, placements=place)


def lay_out(t, mesh, placements):
    """``t`` as a DTensor on ``mesh`` with ``placements`` (a plain tensor
    taken as replicated; a DTensor redistributed where it differs): the
    operands of a ``local_map`` over each rank's blocks."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t if list(t.placements) == list(placements) else \
        t.redistribute(mesh, placements)


def head_input(x, vocab: int) -> tuple:
    """The head's input on a mesh and its logits' layout: the vocabulary
    over "model" where it divides the axis (the reference's rule for
    ``embed`` / ``lm_head``), else the tokens over "model", as XLA lays
    the head out there (the logits' rows split, not their columns).  A
    plain tensor: (x, any spec; ``maybe_constrain`` passes it through)."""
    tp = model_axis_size(x)
    if tp > 1 and vocab % tp:
        spec = (DATA, "model", None)
        return maybe_constrain(x, spec), spec
    return x, (DATA, None, "model")


def heads_flat(t, n: int):
    """(B, S, n hd) with its heads over "model" on a mesh when n splits
    there, else whole (the gradient too: a reshape to or from heads needs
    whole heads in a rank's block); a plain tensor as it is."""
    tp = model_axis_size(t)
    if tp == 1:
        return t
    return maybe_constrain(t, (DATA, None, None if n % tp else "model"))


def maybe_constrain(x, spec):
    """The reference's ``maybe_constrain``: a layout hint.  On a DTensor,
    redistribute ``x`` to ``spec`` (the reference's PartitionSpec as a
    tuple: per dim None, an axis name or a tuple of names) on its own
    mesh, each entry's axes kept only where the mesh has them and their
    sizes divide the dim (the rest of the entry dropped, as the reference
    drops it), and an axis already used by an earlier dim left out; a
    tensor whose layout already matches is returned as it is.  On a plain
    tensor: ``x`` (no mesh, nothing to lay out)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    place = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else \
            ((entry,) if entry else ())
        axes = tuple(a for a in axes if a in names
                     and place[names.index(a)] == Replicate())
        size = 1
        for a in axes:
            size *= mesh.size(names.index(a))
        if axes and x.shape[d] % size == 0:
            for a in axes:
                place[names.index(a)] = Shard(d)
    place = tuple(place)
    if tuple(x.placements) == place and not x.requires_grad:
        return x
    return _Constrain.apply(x, place)


class _Constrain(torch.autograd.Function):
    """A layout constraint: the value redistributed to ``place`` forward;
    its gradient laid out as the input was (a partial sum summed), so the
    products before it keep their split in the backward too (DTensor's
    planner weighs only communication, and would otherwise run a product
    whole on every rank where that moves nothing)."""

    @staticmethod
    def forward(ctx, x, place):
        from torch.distributed.tensor import Replicate
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        if tuple(x.placements) == place:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, place)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.back:
            return g, None
        return g.redistribute(g.device_mesh, ctx.back), None


def _stacked(parts: list) -> bool:
    """Whether a name's parts are ``<group>.<i>.<path>``: row ``i`` of a
    tensor stacked over ``group`` (``layers``, ``periods``, ...)."""
    return len(parts) > 2 and parts[1].isdigit()


def nest_layers(named: dict, stack) -> dict:
    """A model's named tensors (``embed``, ``enc_ln.scale``,
    ``layers.<i>.<name>``, ``layers.<i>.moe.<name>``,
    ``periods.<i>.slot<j>.<name>``, ...) -> the reference's tree: each name
    nested by its dots, and a name ``<group>.<i>.<path>`` stacked over
    ``i`` in order under ``tree[group][path]`` with ``stack`` (a list ->
    tensor function: ``torch.stack``, ``np.stack``)."""
    tree, stacked = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if _stacked(parts):
            stacked.setdefault((parts[0],) + tuple(parts[2:]), []).append(t)
        else:
            stacked[tuple(parts)] = t
    for path, t in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack(t) if isinstance(t, list) else t
    return tree


def lookup(tree: dict, name: str):
    """The entry of the reference's tree holding the named tensor ``name``
    (:func:`nest_layers`' layout): ``<group>.<i>.<path>`` gives row ``i``
    of the stacked ``tree[group][path]``."""
    parts = name.split(".")
    stacked = _stacked(parts)
    node = tree
    for key in ([parts[0]] + parts[2:]) if stacked else parts:
        node = node[key]
    return node[int(parts[1])] if stacked else node


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm computed in float32 and cast back to ``x``'s type."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """The plain two-matrix MLP: tanh-approximate GELU of ``x w_up +
    b_up``, then ``w_down`` and ``b_down``; in ``x``'s type (the weights
    are given in it)."""
    h = F.gelu(x @ w_up + b_up, approximate="tanh")
    return h @ w_down + b_down


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (...,) integers -> (..., head_dim // 2) float32 angles."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    return positions.float()[..., None] * freqs


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin of :func:`rope_angles`, shaped (..., S, 1, head_dim // 2)
    to broadcast over the heads; computed once per forward pass and shared
    by every layer (the reference recomputes them per layer, the same
    values)."""
    ang = rope_angles(positions, head_dim, theta)[..., None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on split halves: x (..., S, n, hd), cos/sin from
    :func:`rope_cos_sin`.  Computed in float32, cast back to ``x``'s
    type."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, hd) against a fixed-size cache
    (B, T, KV, hd); only entries ``t <= pos`` take part.  Scores and the
    softmax in float32, the probabilities cast to q's type before the
    product with v, as in the reference.  Plain torch: the reference
    computes it outside any Pallas kernel."""
    b, _, h, hd = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    # on a mesh: whole heads for the grouping reshape (the cache keeps its
    # own layout, the sequence over "model")
    q = maybe_constrain(q, (DATA, None, None, None))
    qg = q.reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,btkh->bkgqt", qg, k_cache).float()
    scores = scores * (1.0 / math.sqrt(hd))
    valid = torch.arange(t, device=q.device) <= pos
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqt,btkh->bqkgh", probs, v_cache)
    return out.reshape(b, 1, h, hd)


class CastCache:
    """Each parameter's cast to a compute type, the same values as casting
    at every use (as the reference does).

    Under autograd (grad enabled and the parameter requiring grad) the cast
    is made anew at every use and nothing is kept: it stays on the graph,
    so the parameter gets its gradient, and no graph outlives its forward
    (a kept cast would tie one micro-batch's graph to the next).  Otherwise
    (the inference entry points, under ``torch.no_grad()``) the cast is
    kept and made again only when the parameter's storage, version or
    device changes — an optimizer step in place bumps the version."""

    def __init__(self):
        self._casts = {}

    def get(self, name, p, dtype, stationary: bool = False):
        p = gather_data_axes(p, stationary)
        if p.dtype == dtype:
            return p
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(dtype)
        key = (p.data_ptr(), p._version, p.device, dtype)
        hit = self._casts.get(name)
        if hit is None or hit[0] != key:
            hit = (key, p.detach().to(dtype))
            self._casts[name] = hit
        return hit[1]


#: the products "dots" keeps (the reference's
#: checkpoint_dots_with_no_batch_dims: matrix products without a batch
#: dimension; batched products such as attention's are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _recompute_in_layout(inner=None):
    """A checkpoint ``context_fn``: ``inner``'s (forward, recompute)
    contexts, the recompute also under the forward's
    :class:`_WeightStationary` mode.  The recompute runs in the backward,
    where no function mode of the forward is active (``torch.utils.
    checkpoint`` carries only a device context over), and must lay the
    products out as the forward did; without the mode, as ``inner``."""
    fwd, rec = inner() if inner else (contextlib.nullcontext(),
                                      contextlib.nullcontext())
    mode = _stationary_mode()
    if mode is None:
        return fwd, rec

    @contextlib.contextmanager
    def recompute():
        with _WeightStationary(mode.axes), rec:
            yield
    return fwd, recompute()


def remat_wrap(fn, mode: str):
    """``fn`` under the reference's rematerialisation policy: ``"none"``
    keeps every activation, ``"layer"`` keeps only the inputs and recomputes
    the rest in the backward (``torch.utils.checkpoint``), ``"dots"`` keeps
    the outputs of matrix products without a batch dimension and recomputes
    the rest (selective checkpointing).  Recomputation runs the forward
    kernels (K2, K3) again in the backward, in the forward's layout (see
    :func:`batch_layout`)."""
    if mode == "none":
        return fn
    if mode == "layer":
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False,
                                 context_fn=_recompute_in_layout)
    if mode == "dots":
        context = functools.partial(
            _recompute_in_layout, functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _save_dots))
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False, context_fn=context)
    raise ValueError(mode)


def scan_pairs(a: torch.Tensor, u: torch.Tensor) -> tuple:
    """Inclusive scan of the pairs (a_t, u_t) along dim 1 under the
    reference's ``combine`` (earlier, later) -> (a1 a2, a2 u1 + u2), in
    log2(n) steps (each a shift by 1, 2, 4, ... positions): returns (the
    products a_1..a_t, the states from a zero start) at every t."""
    n, d = a.shape[1], 1
    while d < n:
        u = torch.cat([u[:, :d], a[:, d:] * u[:, :-d] + u[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, u


def chunked_linear_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor,
                        chunk: int = 256) -> tuple:
    """Solve h_t = a_t * h_{t-1} + x_t along axis 1 (time) in chunks of
    ``chunk`` steps (the last may be shorter): a, x (B, S, ...) with
    matching trailing dims, h0 (B, ...).  Inside a chunk a log-depth scan
    (:func:`scan_pairs`), then the carry applied to the chunk's prefixes;
    returns (h at the last step, every h_t (B, S, ...)), as the reference.
    The products of a are taken directly, never as exp(cumsum(log a)),
    which overflows under a strong decay."""
    h, ys = h0, []
    for s0 in range(0, x.shape[1], chunk):
        aa, uu = scan_pairs(a[:, s0:s0 + chunk], x[:, s0:s0 + chunk])
        h_all = aa * h[:, None] + uu
        ys.append(h_all)
        h = h_all[:, -1]
    return h, torch.cat(ys, dim=1)


def _on_mesh(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _terms_on_mesh(shifted, idx) -> tuple:
    """(sum of exp, the labels' entries) of DTensor ``shifted`` (..., V),
    each rank's vocab block on its own (``local_map``), partial sums over
    the vocab's mesh axes: the entries as the sum over the block of
    ``shifted`` where the vocab id is the label (one term and exact
    zeros).  As DTensor ops, the gather's backward would scatter into
    zeros of the logits' whole global shape (DTensor's ``new_zeros`` of
    another size is replicated), and the label mask and the sum's
    backward (its cast to the logits' type) would be whole over the vocab
    on every rank."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map
    mesh, last = shifted.device_mesh, shifted.dim() - 1
    s_pl = [Replicate() if p.is_partial() else p for p in shifted.placements]
    if s_pl != list(shifted.placements):
        shifted = shifted.redistribute(mesh, s_pl)
    vocab = [p.is_shard(last) for p in s_pl]
    i_pl = [Replicate() if v else p for v, p in zip(vocab, s_pl)]
    d_pl = [Shard(0) if v else Replicate() for v in vocab]
    o_pl = [Partial() if v else p for v, p in zip(vocab, s_pl)]
    ids = distribute_tensor(torch.arange(shifted.shape[-1],
                                         device=shifted.device),
                            mesh, d_pl, src_data_rank=None)
    if list(idx.placements) != i_pl:
        idx = idx.redistribute(mesh, i_pl)

    def block(s, i, d):
        return (torch.exp(s).sum(dim=-1, dtype=torch.float32),
                (s * (i.unsqueeze(-1) == d)).sum(dim=-1))
    return local_map(block, device_mesh=mesh, out_placements=(o_pl, o_pl),
                     in_placements=(s_pl, i_pl, d_pl))(shifted, idx, ids)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross entropy; logits (B, S, V) any float dtype, labels
    (B, S) integers.  The max-shift is a constant (no gradient), and the
    reductions accumulate in float32, as in the reference."""
    # on a mesh amax reduces each rank's vocab block and then the blocks'
    # maxima; max(dim) also returns indices, which DTensor makes by moving
    # the logits to a layout with the whole vocab on every rank
    m = (torch.amax(logits, dim=-1, keepdim=True) if _on_mesh(logits)
         else logits.max(dim=-1, keepdim=True).values).detach()
    shifted = logits - m
    # ignored positions gather index 0 (masked out below): torch.gather
    # rejects a negative index
    V = shifted.shape[-1]
    idx = labels.long().clamp_min(0)
    if _on_mesh(shifted):
        sumexp, gold = _terms_on_mesh(shifted, idx)
    else:
        sumexp = torch.exp(shifted).sum(dim=-1, dtype=torch.float32)
        gold = torch.gather(shifted.reshape(-1, V), -1,
                            idx.reshape(-1, 1)).reshape(labels.shape)
    # on a mesh: the per-token terms laid out by the batch only, and their
    # gradients too (a layout DTensor picks for them, the sequence over
    # "model", would move the logits' gradient there by an all-to-all)
    sumexp = maybe_constrain(sumexp, (DATA, None))
    gold = maybe_constrain(gold, (DATA, None))
    nll = torch.log(sumexp) - gold.float()
    mask = labels != ignore_id
    return (nll * mask).sum() / mask.sum().clamp_min(1)
