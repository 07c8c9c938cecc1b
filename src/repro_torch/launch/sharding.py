"""Sharding rules: param / batch / cache partition specs per architecture —
the port of ``repro/launch/sharding.py``.

Baseline layout (the reference's):
  - tensor parallel on "model": attention heads, FFN hidden, MoE experts
    (when E % tp == 0, else the per-expert FFN hidden), vocab/embedding;
  - fully-sharded (FSDP-style) parameter + optimizer-state storage: the
    d_model axis additionally shards over ("pod", "data");
  - batch over ("pod", "data");
  - decode caches: batch over the data axes when divisible, cache length
    over "model".

The rules are pure functions of (config, layout, leaf path, shape,
policy): a *spec* is the reference's ``PartitionSpec`` as a tuple, one
entry a tensor dim — ``None``, an axis name, or a tuple of axis names
(major to minor; a one-name tuple is written as the name, as
``PartitionSpec`` prints it).  A mesh argument is a
``launch/mesh.py::MeshLayout`` or a ``DeviceMesh``.  :func:`placements`
turns a spec into DTensor placements on a mesh; :class:`NamedSharding`
pairs the two, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.common import ArchConfig

from .mesh import as_layout


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Knobs the reference's perf pass iterates on."""
    fsdp: bool = True              # shard d_model of params over data axes
    shard_vocab: bool = True
    cache_seq_on_model: bool = True
    batch_axes: tuple = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a ``MeshLayout`` or a ``DeviceMesh``)."""
    mesh: Any
    spec: tuple

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _entry(axes) -> Any:
    """A spec entry from a tuple of axis names: None, a name or a tuple."""
    axes = tuple(axes) if axes else ()
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _divisible(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _axis_size(lay, name) -> int:
    return lay.shape[name] if name in lay.axis_names else 1


def _data_spec(lay, policy, dim: int) -> Any:
    axes = tuple(a for a in policy.batch_axes if a in lay.axis_names)
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= lay.shape[a]
    return _entry(axes) if _divisible(dim, total) else None


_PROJECTIONS = ("wq", "wk", "wv", "wg", "wr", "wk2", "wo", "w_gate", "w_up",
                "w_down", "ck", "cv", "cr", "in_proj", "out_proj", "x_proj",
                "dt_proj", "x_wq", "x_wk", "x_wv", "x_wo", "conv_w")
_OUT_FIRST = ("wo", "w_down", "cv", "out_proj", "x_wo")


def param_spec(cfg: ArchConfig, mesh, path: str, shape: tuple,
               policy: ShardingPolicy = ShardingPolicy()) -> tuple:
    """The spec of one parameter leaf, identified by its tree path
    (``"layers/wq"``)."""
    lay = as_layout(mesh)
    tp = _axis_size(lay, "model")
    dsz = 1
    for a in policy.batch_axes:
        dsz *= _axis_size(lay, a)
    dax = _entry(a for a in policy.batch_axes if a in lay.axis_names)
    name = path.split("/")[-1]
    nd = len(shape)

    def fsdp_axis(candidates):
        """One remaining axis to shard over the data axes (FSDP)."""
        if not policy.fsdp or dax is None:
            return None
        for ax in candidates:
            if shape[ax] and _divisible(shape[ax], dsz):
                return ax
        return None

    spec = [None] * nd
    # embeddings / heads: vocab on "model" only (an FSDP-sharded d makes
    # the token gather unpartitionable, the reference measured)
    if name in ("embed", "tok_embed", "dec_pos"):
        if policy.shard_vocab and _divisible(shape[0], tp):
            spec[0] = "model"
        return tuple(spec)
    if name == "lm_head":
        if policy.shard_vocab and _divisible(shape[-1], tp):
            spec[-1] = "model"
        ax = fsdp_axis([0])
        if ax is not None:
            spec[ax] = dax
        return tuple(spec)
    # MoE expert tensors (leading L, then E)
    if "moe" in path and name in ("w_gate", "w_up", "w_down"):
        e_ax = nd - 3
        if _divisible(shape[e_ax], tp):
            spec[e_ax] = "model"           # expert parallelism
            ax = fsdp_axis([nd - 2, nd - 1])
            if ax is not None and spec[ax] is None:
                spec[ax] = dax
        else:
            # per-expert tensor parallelism, no FSDP (it conflicts with
            # the batch-sharded dispatch buffer in the reference)
            hid = nd - 1 if name != "w_down" else nd - 2
            if _divisible(shape[hid], tp):
                spec[hid] = "model"
        return tuple(spec)
    if name == "router":
        if _divisible(shape[-1], tp):
            spec[-1] = "model"
        return tuple(spec)
    # attention / dense FFN / projections (stacked: axis 0 = L or P)
    if nd >= 2 and name in _PROJECTIONS:
        out_first = name in _OUT_FIRST
        big = nd - 2 if out_first else nd - 1      # the "parallel" axis
        other = nd - 1 if out_first else nd - 2
        if _divisible(shape[big], tp):
            spec[big] = "model"
        elif _divisible(shape[other], tp):
            spec[other] = "model"
            other = big
        ax = fsdp_axis([other])
        if ax is not None and spec[ax] is None:
            spec[ax] = dax
        return tuple(spec)
    # everything else (norms, biases, decay vectors, A_log, ...)
    return tuple(spec)


#: biases the rules leave whole, and the matrix whose output dim each
#: follows when a rank holds a block of that matrix's columns
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv", "b_up": "w_up"}


def model_dim(cfg: ArchConfig, mesh, path: str, shape: tuple,
              policy: ShardingPolicy = ShardingPolicy()):
    """The dim of the leaf at ``path`` that :func:`param_spec` splits over
    the "model" axis, or None.  A bias of :data:`_BIAS_OF` takes its
    matrix's output split (its matrix's shape is the bias's with d_model
    before the last dim)."""
    *head, name = path.split("/")
    if name in _BIAS_OF:
        mshape = tuple(shape[:-1]) + (cfg.d_model, shape[-1])
        spec = param_spec(cfg, mesh, "/".join(head + [_BIAS_OF[name]]),
                          mshape, policy)
        return len(shape) - 1 if spec[-1] == "model" else None
    spec = param_spec(cfg, mesh, path, shape, policy)
    for d, e in enumerate(spec):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        if "model" in axes:
            if axes != ("model",):
                raise ValueError(f"{path}: dim {d} is split over {axes}; a "
                                 "model block is cut along 'model' alone")
            return d
    return None


def model_block(cfg: ArchConfig, mesh, path: str, x, rank: int,
                policy: ShardingPolicy = ShardingPolicy()):
    """Rank ``rank``'s block of the leaf ``x`` (at tree path ``path``, in
    the reference's stacked layout) along the mesh's "model" axis: the dim
    :func:`model_dim` names cut into ``tp`` equal blocks, or ``x`` itself
    when no dim is split.  A view, for tensors and arrays alike."""
    d = model_dim(cfg, mesh, path, tuple(x.shape), policy)
    if d is None:
        return x
    tp = _axis_size(as_layout(mesh), "model")
    n = x.shape[d] // tp
    idx = [slice(None)] * len(x.shape)
    idx[d] = slice(rank * n, (rank + 1) * n)
    return x[tuple(idx)]


def data_dim(cfg: ArchConfig, mesh, path: str, shape: tuple,
             policy: ShardingPolicy = ShardingPolicy()):
    """The dim of the leaf at ``path`` that :func:`param_spec` splits over
    the data axes (its FSDP block), or None."""
    lay = as_layout(mesh)
    dax = _entry(a for a in policy.batch_axes if a in lay.axis_names)
    if dax is None:
        return None
    spec = param_spec(cfg, mesh, path, shape, policy)
    return next((d for d, e in enumerate(spec) if e == dax), None)


def data_block(cfg: ArchConfig, mesh, path: str, x, rank: int,
               policy: ShardingPolicy = ShardingPolicy()):
    """Data rank ``rank``'s block of the leaf ``x`` (at tree path ``path``,
    in the reference's stacked layout): the dim :func:`data_dim` names
    cut into as many equal blocks as the data axes have ranks (major to
    minor: ``rank`` = pod index x data size + data index), or ``x``
    itself when no dim is split.  A view, for tensors and arrays alike."""
    d = data_dim(cfg, mesh, path, tuple(x.shape), policy)
    if d is None:
        return x
    lay = as_layout(mesh)
    n = x.shape[d]
    for a in policy.batch_axes:
        n //= _axis_size(lay, a)
    idx = [slice(None)] * len(x.shape)
    idx[d] = slice(rank * n, (rank + 1) * n)
    return x[tuple(idx)]


def _flatten(tree, prefix=()) -> list:
    """[(path components, leaf)] of a nested dict / list / tuple, dict keys
    in sorted order (``jax.tree_util``'s)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _map(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def param_sharding_tree(cfg: ArchConfig, mesh, param_shapes,
                        policy: ShardingPolicy = ShardingPolicy()):
    """``param_shapes``: a tree of tensors (``configs.param_specs``' meta
    tensors) -> the same tree of :class:`NamedSharding`."""
    return _map(lambda path, leaf: NamedSharding(
        mesh, param_spec(cfg, mesh, path, tuple(leaf.shape), policy)),
        param_shapes)


def opt_sharding_tree(mesh, optimizer_name: str, params_sharding,
                      params_shapes):
    """Optimizer-state shardings, in the layout of ``optim``'s states:
    moments (AdamW m / v, momentum m) take their parameter's; Adafactor's
    factored statistics drop the factored axis of it; scalars
    replicate."""
    rep = NamedSharding(mesh, ())
    if optimizer_name == "sgd":
        return {}
    if optimizer_name == "momentum":
        return {"m": params_sharding}
    if optimizer_name == "adamw":
        return {"m": params_sharding, "v": params_sharding, "t": rep}
    if optimizer_name == "adafactor":
        shapes = dict(_flatten(params_shapes))

        def leaf(path, sh):
            nd = len(shapes[tuple(path.split("/")) if path else ()].shape)
            spec = list(sh.spec) + [None] * (nd - len(sh.spec))
            if nd >= 2:
                return {"vr": NamedSharding(mesh, tuple(spec[:-1])),
                        "vc": NamedSharding(mesh,
                                            tuple(spec[:-2] + spec[-1:]))}
            return {"v": NamedSharding(mesh, tuple(spec))}
        return {"f": _map(leaf, params_sharding), "t": rep}
    raise ValueError(optimizer_name)


def batch_sharding(cfg: ArchConfig, mesh, batch_shapes,
                   policy: ShardingPolicy = ShardingPolicy()):
    """Every batch array's leading (batch) dim over the data axes."""
    lay = as_layout(mesh)

    def spec_for(_, s):
        nd = len(s.shape)
        return NamedSharding(mesh, (_data_spec(lay, policy, s.shape[0]),)
                             + (None,) * (nd - 1))
    return _map(spec_for, batch_shapes)


def cache_sharding(cfg: ArchConfig, mesh, cache_shapes,
                   policy: ShardingPolicy = ShardingPolicy()):
    """Decode caches: (L/P, B, T, kv, hd) KV tensors -> batch over data, T
    over "model"; recurrent / conv states -> batch over data, the feature
    dim over "model" when divisible."""
    lay = as_layout(mesh)
    tp = _axis_size(lay, "model")

    def spec_for(_, s):
        sh = tuple(s.shape)
        nd = len(sh)
        spec = [None] * nd
        if nd >= 2:
            spec[1] = _data_spec(lay, policy, sh[1])     # batch dim
        if nd == 5:                                      # (L, B, T, kv, hd)
            if policy.cache_seq_on_model and _divisible(sh[2], tp):
                spec[2] = "model"
            elif _divisible(sh[3], tp):
                spec[3] = "model"
        elif nd == 4:                                    # (L, B, X, Y)
            if _divisible(sh[3], tp):
                spec[3] = "model"
            elif _divisible(sh[2], tp):
                spec[2] = "model"
        elif nd == 3 and _divisible(sh[2], tp):
            spec[2] = "model"
        return NamedSharding(mesh, tuple(spec))

    return _map(spec_for, cache_shapes)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the mesh axis names tensor dim d, else
    ``Replicate()``.  A dim split over several axes (("pod", "data")) is
    split by DTensor over those mesh dims in mesh order, the first the
    major one — the reference's major-to-minor split — so its axes must
    appear in mesh order; an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = as_layout(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} lists its axes out of the "
                             f"mesh's order {names}; DTensor splits a dim "
                             "over mesh dims in mesh order")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return tuple(out)
