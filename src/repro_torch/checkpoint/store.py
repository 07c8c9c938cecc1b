"""npz checkpoints + JSON metadata, with async save — the port of
``repro/checkpoint/store.py``.

Layout:  <dir>/step_<N>/arrays.npz  +  <dir>/step_<N>/meta.json
(``N`` zero-padded to 8 digits), the reference's, so a checkpoint written by
either package restores in the other.  A tree is nested dicts, lists and
tuples of tensors; it is flattened to the reference's leaf keys — path
components joined by ``/`` (``"a/b/0"``), dict keys in sorted order.
Arrays are stored on the host, unsharded; a restore places each tensor on
the device of the matching tensor in the caller's like-tree, or, given
``shardings=`` (a tree of ``launch/sharding.py::NamedSharding`` on a
``DeviceMesh``), re-shards it onto the current mesh: every rank reads the
npz and keeps its own shard as a DTensor, so a checkpoint written on one
mesh restores onto another.  Saving a tree of DTensors gathers each leaf
(``full_tensor()``, a collective every rank joins) and rank 0 writes.  A
``scratch -> rename`` commit keeps partially written checkpoints invisible
to ``latest_step``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from .._device import resolve_device


def _flatten_with_paths(tree, prefix=()) -> list:
    """``[(key, leaf)]`` in the reference's leaf order: dict keys sorted,
    sequences by index, ``None`` holding no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (str(i),))
        return out
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if like is None:
        return None
    return next(leaves)


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a DTensor gathered whole).  bfloat16
    (no numpy dtype) is stored as float32, which holds every bfloat16 value
    exactly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree, *, meta: dict = None,
                    blocking: bool = True):
    """Host-gather + write.  With ``blocking=False`` the disk write happens
    on a background thread (training continues; join via
    ``CheckpointStore.wait``) and the thread is returned.  A tree holding
    DTensors is gathered on every rank (each must call this) and written
    by rank 0 alone; a blocking save then waits for every rank."""
    items = _flatten_with_paths(tree)
    sharded = any(_is_dtensor(v) for _, v in items)
    arrays = {k: _host_array(v) for k, v in items}
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return None
    payload_meta = {"step": step, "time": time.time(),
                    "bytes": int(sum(a.nbytes for a in arrays.values())),
                    **(meta or {})}

    def write():
        final = os.path.join(directory, f"step_{step:08d}")
        scratch = final + ".tmp"
        os.makedirs(scratch, exist_ok=True)
        t0 = time.perf_counter()
        np.savez(os.path.join(scratch, "arrays.npz"), **arrays)
        payload_meta["write_seconds"] = time.perf_counter() - t0
        with open(os.path.join(scratch, "meta.json"), "w") as f:
            json.dump(payload_meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(scratch, final)

    if blocking:
        write()
        if sharded:
            import torch.distributed as dist
            dist.barrier()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def estimate_restore_seconds(directory: str, step: int | None = None, *,
                             read_bandwidth: float | None = None) -> float:
    """Predicted wall-clock of ``restore_checkpoint`` for an existing
    checkpoint, from its recorded metadata — the restore charge the elastic
    coordinator adds when a ``NodeFailure`` forces a resume.

    With ``read_bandwidth`` (bytes/s) the estimate is
    ``bytes / read_bandwidth``; without it, the measured write time stands
    in for the read-back.  Returns 0.0 when no checkpoint exists.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return 0.0
    path = os.path.join(directory, f"step_{step:08d}", "meta.json")
    try:
        with open(path) as f:
            meta = json.load(f)
    except OSError:
        return 0.0
    if read_bandwidth is not None and read_bandwidth > 0:
        return float(meta.get("bytes", 0)) / read_bandwidth
    return float(meta.get("write_seconds", 0.0))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like_tree, *,
                       shardings=None, device="cuda"):
    """Restore into the structure of ``like_tree``: each leaf takes its like
    tensor's dtype and device (a like leaf that is not a tensor — a numpy
    array — gives a tensor on ``device``, ``"cuda"`` unless the caller
    passes ``"cpu"``).  With ``shardings`` (the like-tree's structure, a
    ``launch/sharding.py::NamedSharding`` on a ``DeviceMesh`` a leaf) each
    leaf becomes a DTensor on that mesh: this rank's shard of the stored
    array, on the mesh's device type.  Returns ``(tree, meta)``."""
    if shardings is not None:
        shard_of = _shardings_by_key(like_tree, shardings)
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    leaves = []
    for key, like in _flatten_with_paths(like_tree):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        a = arrays[key]
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {a.shape} vs {like.shape}")
        if isinstance(like, torch.Tensor):
            t = torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
        else:
            t = torch.from_numpy(a.astype(like.dtype)).to(dev)
        if shardings is not None:
            t = _distribute(t, shard_of[key])
        leaves.append(t)
    tree = _unflatten(like_tree, iter(leaves))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return tree, meta


def _shardings_by_key(like_tree, shardings) -> dict:
    """{leaf key: NamedSharding}, checking ``shardings`` holds one
    ``launch/sharding.py::NamedSharding`` on a ``DeviceMesh`` for every
    leaf of ``like_tree``."""
    from torch.distributed.device_mesh import DeviceMesh
    from ..launch.sharding import NamedSharding
    if isinstance(shardings, (dict, list, tuple)):
        items = dict(_flatten_with_paths(shardings))
    else:
        items = {"": shardings}
    for key, sh in items.items():
        if not (isinstance(sh, NamedSharding)
                and isinstance(sh.mesh, DeviceMesh)):
            raise TypeError(
                f"shardings[{key!r}] is a {type(sh).__name__}; restore "
                "takes a tree of launch.sharding.NamedSharding on a "
                "DeviceMesh")
    want = [k for k, _ in _flatten_with_paths(like_tree)]
    missing = [k for k in want if k not in items]
    if missing:
        raise KeyError(f"shardings has no entry for leaves {missing}")
    return items


def _distribute(t: torch.Tensor, sharding):
    """This rank's shard of the whole tensor ``t`` as a DTensor (no
    communication: every rank holds ``t``)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, sharding.placements(),
                             src_data_rank=None)


@dataclasses.dataclass
class CheckpointStore:
    """Keeps the last ``keep`` checkpoints; tracks async writes."""
    directory: str
    keep: int = 3
    _threads: list = dataclasses.field(default_factory=list)

    def save(self, step: int, tree, *, meta: dict = None,
             blocking: bool = False):
        t = save_checkpoint(self.directory, step, tree, meta=meta,
                            blocking=blocking)
        if t is not None:
            self._threads.append(t)
        self._gc()

    def wait(self):
        for t in self._threads:
            t.join()
        self._threads.clear()

    def restore_latest(self, like_tree, *, shardings=None, device="cuda"):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        self.wait()
        return restore_checkpoint(self.directory, step, like_tree,
                                  shardings=shardings, device=device)

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
