"""The dry run: trace one rank's step of every (arch x shape x mesh) cell
without a device — the counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory analysis and the HLO's FLOPs, traffic and
collectives.  The port has no compiler in between: it runs the step
itself, on fake tensors (``torch._subclasses.FakeTensorMode``: shapes and
types, no data) over a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``; this process is rank 0,
every collective returns at once), and counts what rank 0 runs with
``utils/cost.py::CostCounter``:

- the parameters come from ``configs.param_specs`` as DTensors placed by
  the sharding rules (``launch/sharding.py``; each rank holds its block),
  the optimizer state as theirs, the inputs from ``input_specs`` (and
  ``cache_specs``) placed by the batch and cache rules;
- the step is ``launch/steps.py``'s ``make_train_step`` /
  ``make_prefill_step`` / ``make_decode_step``, or for ``--mode pipeline``
  ``pipeline/spmd.py::make_pipelined_train_step`` on
  ``launch/mesh.py::pipeline_layout`` (each rank's leaves in the rules'
  blocks: its stage's layers cut to their FSDP and "model" blocks, the
  embedding to its vocabulary block, AdamW's moments alike);
- on ``--device cuda`` (the default) the tensors are fake CUDA tensors, so
  K2 / K2' / K3 / K3' take their fake branches and charge their work;
  on ``cpu`` the plain attention and scan run, as the reference's dry run
  lowers them (``use_pallas`` False).  Fake CUDA tensors need a CUDA
  build of torch (a CPU-only build has no CUDA device guard for the
  autograd engine, nor a device handle for a CUDA ``DeviceMesh``); there
  ``cuda`` raises and ``cpu`` traces the same step.

The record keeps the reference's keys (``:127-151``) with these changes:
``fits_80gb`` (one H100's 80 GB) replaces ``fits_16gb``; there is no
``cpu_f32_promotion_bytes`` (an XLA:CPU artifact); ``memory`` holds the
argument bytes (the local blocks of the step's inputs on rank 0), the
output bytes (new storages the step returns) and the temp bytes (the
peak of live bytes above the arguments); ``while_trip_counts`` and
``unresolved_loops`` are empty / 0 (torch counts every pass of a loop).
A serving cell's cache is laid out by the cache rules as the step returns
it (the reference's ``out_shardings``), and its record adds ``cache``:
each leaf's global shape and placements.
The process group is made in :func:`run_cells` (or by a caller through
:func:`fake_process_group`) and destroyed after it, never at import.

Usage:
  python -m repro_torch.launch.dryrun                      # all cells
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      --mesh single --device cpu
  python -m repro_torch.launch.dryrun --mode pipeline ...  # paper mode
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 cache_specs, param_specs, supports_shape)
from repro_torch.core.network import H100_HBM_BYTES
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import (MeshLayout, as_layout, mesh_tag,
                                     pipeline_layout, production_layout)
from repro_torch.launch.steps import (default_microbatches,
                                      default_optimizer_name,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.common import _stacked, batch_layout
from repro_torch.optim import get_optimizer
from repro_torch.utils.cost import CostCounter, op_histogram

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

#: one H100's memory
FIT_BYTES = H100_HBM_BYTES


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the duration of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


@contextlib.contextmanager
def _traced(counter):
    """The counter, with plain tensors met beside DTensors (RoPE's tables,
    masks) taken as replicated, and DTensor's strided-shard index math
    (small ``arange`` tensors it reads back) run outside the fake mode."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.placement_types import _StridedShard
    original = _StridedShard.local_shard_size_and_offset

    def real(self, *args, **kwargs):
        with _no_fake():
            return original(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real
    try:
        with implicit_replication(), counter:
            yield
    finally:
        _StridedShard.local_shard_size_and_offset = original


@contextlib.contextmanager
def _one_microbatch(counter: CostCounter):
    """The train step's Q micro-batches have one shape: trace the first
    and count it Q times (``CostCounter.repeat``; the reference scales a
    scanned body by its trip count), the gradient accumulation's
    elementwise ops with it; the optimizer's update is traced once.  Its
    forward runs in the micro-batch's :func:`batch_layout` (a remat
    recompute in the backward re-enters it)."""
    import repro_torch.launch.steps as steps_mod
    from repro_torch.pipeline.executor import split_batch
    original = steps_mod.microbatch_grads

    def once(loss_fn, params, batch, q):
        if q == 1:
            with batch_layout(batch["tokens"]):
                return original(loss_fn, params, batch, 1)
        first = {k: v[0] for k, v in split_batch(batch, q).items()}
        with counter.repeat(q), batch_layout(first["tokens"]):
            return original(loss_fn, params, first, 1)

    steps_mod.microbatch_grads = once
    try:
        yield
    finally:
        steps_mod.microbatch_grads = original


def _check_device(dev: str) -> None:
    if dev == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "fake CUDA tensors need a CUDA build of torch (a CPU-only build "
            "has no CUDA device guard for the autograd engine nor a device "
            "handle for a CUDA DeviceMesh); trace with --device cpu here")


def _param_path(name: str) -> str:
    """A model's parameter name -> its path in the reference's tree
    (``layers.3.moe.router`` -> ``layers/moe/router``)."""
    parts = name.split(".")
    if _stacked(parts):
        parts = [parts[0]] + parts[2:]
    return "/".join(parts)


def _device_mesh(layout: MeshLayout, dev: str):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev, torch.arange(layout.size).reshape(layout.sizes),
                      mesh_dim_names=layout.axis_names)


def _local(global_shape, dtype, dev, mesh, place):
    """A fake DTensor of ``global_shape`` placed by ``place``, rank 0's
    block allocated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with _no_fake():
        local_shape, _ = compute_local_shape_and_global_offset(
            tuple(global_shape), mesh, place)
    local = torch.empty(local_shape, dtype=dtype, device=dev)
    stride = torch.empty(global_shape, device="meta").stride()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=torch.Size(global_shape), stride=stride)


@contextlib.contextmanager
def _no_fake():
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        yield


def _sharded_model(cfg, layout, mesh, dev, policy, grad=True):
    """The model of ``cfg`` with every parameter a fake DTensor placed by
    the rules: a stacked leaf's spec without its leading layer axis
    (``grad``: whether they require a gradient)."""
    from repro_torch.configs.base import _model_class
    model = _model_class(cfg)(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        path = _param_path(name)
        stacked = path != name.replace(".", "/")
        # a stacked leaf's rule sees its whole stack: (group length, ...)
        shape = ((len(getattr(model, name.split(".")[0])),) if stacked
                 else ()) + tuple(p.shape)
        spec = shlib.param_spec(cfg, layout, path, shape, policy)
        place = shlib.placements(spec[1:] if stacked else spec, mesh)
        t = torch.nn.Parameter(_local(p.shape, p.dtype, dev, mesh, place),
                               requires_grad=grad)
        *owner, attr = name.split(".")
        setattr(model.get_submodule(".".join(owner)) if owner else model,
                attr, t)
    return model


def _batch(specs: dict, layout, mesh, dev, cfg, policy) -> dict:
    sh = shlib.batch_sharding(cfg, layout, specs, policy)
    return {k: _local(v.shape, v.dtype, dev, mesh,
                      shlib.placements(sh[k].spec, mesh))
            for k, v in specs.items()}


def _mem_dict(args: int, out: int, temp: int) -> dict:
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out,
            "temp_size_in_bytes": temp, "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": 0}


def _finish(rec: dict, counter: CostCounter, args: int, outs, t0: float,
            devices: int) -> dict:
    """The record's cost, memory and fit fields from a finished trace."""
    from torch.utils._pytree import tree_flatten
    out_bytes = 0
    seen = set()
    for t in tree_flatten(outs)[0]:
        if isinstance(t, torch.Tensor):
            from repro_torch.utils.cost import _is_dtensor, _storage_key
            t = t._local_tensor if _is_dtensor(t) else t
            key, _ = _storage_key(t)
            if key not in counter._args and key not in seen:
                seen.add(key)
                out_bytes += t.untyped_storage().nbytes()
    cost = counter.cost()
    mem = _mem_dict(args, out_bytes, counter.peak_temp_bytes)
    hbm = float(args + out_bytes + counter.peak_temp_bytes)
    rec.update(
        lower_compile_seconds=round(time.time() - t0, 2),
        devices=devices,
        memory=mem,
        xla_flops_per_device=cost.flops,
        xla_bytes_per_device=cost.traffic_bytes,
        flops_per_device=cost.flops,
        bytes_per_device=cost.traffic_bytes,
        collective_bytes_per_device=cost.collective_bytes,
        collective_breakdown=cost.collective_by_kind,
        while_trip_counts=[],
        unresolved_loops=0,
        op_histogram=op_histogram(cost, top=12),
        kernels=cost.kernels,
        hbm_per_device=hbm,
        fits_80gb=bool(hbm < FIT_BYTES),
    )
    return rec


def _lower_cell(arch: str, shape: str, mesh, *, policy=None,
                q_override=None, device: str = "cuda", cfg=None,
                batch_override=None, breakdown: bool = False):
    """Trace one cell of the baseline layout (``mesh`` a ``MeshLayout`` of
    the process group's size); returns the record dict.  ``cfg`` replaces
    ``get_config(arch)`` (a reduced or re-timed config), and
    ``batch_override`` = (global batch, sequence) the shape's;
    ``breakdown`` adds ``peak_temp_by_op`` (what is alive at the peak) and
    ``flops_by_op`` (the FLOPs by product and shapes)."""
    import torch.distributed as dist
    cfg = cfg or get_config(arch)
    if os.environ.get("REPRO_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["REPRO_REMAT"])
    sp = SHAPES[shape]
    if batch_override is not None:
        sp = dataclasses.replace(sp, global_batch=batch_override[0],
                                 seq_len=batch_override[1])
    _check_device(device)
    layout = as_layout(mesh)
    if dist.get_world_size() != layout.size:
        raise ValueError(f"a {mesh_tag(layout)} mesh needs a process group "
                         f"of {layout.size}")
    policy = policy or shlib.ShardingPolicy()
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_tag(layout),
           **({"tokens": sp.global_batch * (
               1 if sp.kind == "decode" else sp.seq_len)}
              if batch_override is not None else {}),
           "kind": sp.kind, "policy": dataclasses.asdict(policy),
           "device": device}
    specs = _input_specs(cfg, sp)
    layout = _traced_layout(layout, policy)
    dmesh = _device_mesh(layout, device)
    with _fake_mode():
        if sp.kind == "train":
            opt_name = default_optimizer_name(cfg)
            q = q_override or default_microbatches(cfg, sp.global_batch)
            opt = get_optimizer(opt_name)
            model = _sharded_model(cfg, layout, dmesh, device, policy)
            from repro_torch.launch.steps import init_optimizer
            state = init_optimizer(opt, model)
            batch = _batch(specs, layout, dmesh, device, cfg, policy)
            step = make_train_step(cfg, opt, q, device)
            rec.update(optimizer=opt_name, microbatches=q)
            counter = CostCounter(track_memory=True, breakdown=breakdown)
            args = counter.mark_arguments(list(model.parameters()), state,
                                          batch)
            with _traced(counter), _one_microbatch(counter):
                outs = step(model, state, batch)
        elif sp.kind == "prefill":
            cfg_srv = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
            model = _sharded_model(cfg_srv, layout, dmesh, device, policy,
                                   grad=False)
            batch = _batch(specs, layout, dmesh, device, cfg, policy)
            step = make_prefill_step(cfg_srv, sp.seq_len + cfg.patch_tokens,
                                     device)
            counter = CostCounter(track_memory=True, breakdown=breakdown)
            args = counter.mark_arguments(list(model.parameters()), batch)
            with _traced(counter), torch.no_grad(), \
                    batch_layout(batch["tokens"]):
                outs = step(model, batch)
                outs = (outs[0], _by_rules(outs[1], cfg_srv, layout, dmesh,
                                           policy))
        else:
            cfg_srv = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
            model = _sharded_model(cfg_srv, layout, dmesh, device, policy,
                                   grad=False)
            cache = _cache(cfg_srv, sp, layout, dmesh, device, policy)
            tok = _batch({"t": specs["token"]}, layout, dmesh, device, cfg,
                         policy)["t"]
            step = make_decode_step(cfg_srv, device)
            counter = CostCounter(track_memory=True, breakdown=breakdown)
            args = counter.mark_arguments(list(model.parameters()), cache,
                                          tok)
            with _traced(counter), torch.no_grad(), batch_layout(tok):
                outs = step(model, cache, tok, sp.seq_len - 1)
                outs = (outs[0], _by_rules(outs[1], cfg_srv, layout, dmesh,
                                           policy))
    if sp.kind != "train":
        rec["cache"] = _layouts(outs[1])
    if breakdown:
        rec["peak_temp_by_op"] = counter.peak_by_op()
        rec["flops_by_op"] = counter.flops_by_op()
    return _finish(rec, counter, args, outs, t0, layout.size)


def _by_rules(cache, cfg, layout, mesh, policy):
    """The cache a serving step returns, each leaf laid out by the cache
    rules (the reference's ``out_shardings``; a leaf already there as it
    is)."""
    if isinstance(cache, dict):
        return {k: _by_rules(v, cfg, layout, mesh, policy)
                for k, v in cache.items()}
    spec = shlib.cache_sharding(cfg, layout, cache, policy).spec
    place = shlib.placements(spec, mesh)
    return cache if tuple(cache.placements) == place else \
        cache.redistribute(mesh, place)


def _layouts(tree, path="") -> dict:
    """{leaf path: {"shape": its global shape, "placements": each mesh
    dim's placement}} of a (nested) dict of DTensors (the serving cells'
    cache as the step returns it)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layouts(v, f"{path}{k}/"))
        else:
            out[path + k] = {"shape": list(v.shape),
                             "placements": [str(p) for p in v.placements]}
    return out


def _traced_layout(layout: MeshLayout, policy) -> MeshLayout:
    """The layout the step is traced on: a multi-pod mesh's "pod" and
    "data" axes folded into one "data" axis of their product when the
    batch axes are the pair (the rules and the models' hints name them
    only together, as ("pod", "data"), so every split and every per-device
    figure is the same; a collective over the pair is then one over its
    ranks, as XLA emits it, where DTensor would run one per axis, and
    DTensor plans ops on a 2-D mesh far faster than on a 3-D one)."""
    names = layout.axis_names
    if tuple(policy.batch_axes) != ("pod", "data") or names[:2] != (
            "pod", "data"):
        return layout
    return MeshLayout(("data",) + names[2:],
                      (layout.sizes[0] * layout.sizes[1],) + layout.sizes[2:])


def _input_specs(cfg, sp) -> dict:
    """``input_specs`` at the cell's (possibly overridden) batch."""
    name = next(n for n, s in SHAPES.items() if s.kind == sp.kind)
    specs = input_specs(cfg, name)
    B, S = sp.global_batch, sp.seq_len

    def resize(t):
        shape = list(t.shape)
        if shape:
            shape[0] = B
            if len(shape) > 1 and sp.kind != "decode" and t.dtype in (
                    torch.int32, torch.int64):
                shape[1] = S
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return {k: resize(v) for k, v in specs.items()}


def _cache(cfg, sp, layout, mesh, dev, policy):
    """The family's cache (``cache_specs``) at the cell's batch and length
    as fake DTensors placed by the cache rules: a KV cache's length axis
    takes the cell's length; a WKV or Mamba state, and whisper's cross
    keys and values over its frames, keep their own sizes."""
    name = next(n for n, s in SHAPES.items() if s.kind == "decode")

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        spec = shlib.cache_sharding(cfg, layout, tree, policy).spec
        return _local(tree.shape, tree.dtype, dev, mesh,
                      shlib.placements(spec, mesh))
    return build(cache_specs(cfg, name, batch=sp.global_batch,
                             seq_len=sp.seq_len))


def _lower_pipeline_cell(arch: str, mesh, *, num_stages: int = 4,
                         q: int = 16, device: str = "cuda", cfg=None,
                         batch_override=None, shape: str = "train_4k",
                         breakdown: bool = False):
    """Paper-mode train cell: rank 0's pipelined step
    (``pipeline/spmd.py``) on ``mesh`` (a ``MeshLayout`` with "stage" and
    "model" axes, of the process group's size); ``breakdown`` as
    :func:`_lower_cell`'s."""
    import torch.distributed as dist
    from repro_torch.pipeline import (PipelineConfig,
                                      make_pipelined_train_step)
    from repro_torch.pipeline.spmd import shard_params
    cfg = cfg or get_config(arch)
    if os.environ.get("REPRO_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["REPRO_REMAT"])
    sp = SHAPES[shape]
    if batch_override is not None:
        sp = dataclasses.replace(sp, global_batch=batch_override[0],
                                 seq_len=batch_override[1])
    _check_device(device)
    layout = as_layout(mesh)
    if dist.get_world_size() != layout.size:
        raise ValueError(f"a {mesh_tag(layout)} mesh needs a process group "
                         f"of {layout.size}")
    if cfg.num_layers % num_stages:
        raise ValueError(f"{arch}: L={cfg.num_layers} % stages={num_stages}")
    t0 = time.time()
    opt_name = default_optimizer_name(cfg)
    pcfg = PipelineConfig(num_stages=num_stages, num_microbatches=q)
    specs = _input_specs(cfg, sp)
    with _fake_mode():
        opt = get_optimizer(opt_name)
        # the step first: it refuses a family or a model axis it cannot run
        step = make_pipelined_train_step(cfg, layout, pcfg, opt, device)
        whole = _fake_tree(param_specs(cfg), device)
        local = shard_params(whole, layout, pcfg, device, cfg=cfg)
        del whole
        state = opt.init(local)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in specs.items()}
        counter = CostCounter(track_memory=True, pipe=step.pipe,
                              breakdown=breakdown)
        args = counter.mark_arguments(local, state, batch)
        with counter:
            outs = step(local, state, batch)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_tag(layout),
           **({"tokens": sp.global_batch * sp.seq_len}
              if batch_override is not None else {}),
           "kind": "train-pipeline", "num_stages": num_stages,
           "microbatches": q, "optimizer": opt_name, "device": device,
           "rank": {"data": step.pipe.d, "stage": step.pipe.k,
                    "model": step.pipe.m}}
    if breakdown:
        rec["peak_temp_by_op"] = counter.peak_by_op()
        rec["flops_by_op"] = counter.flops_by_op()
    return _finish(rec, counter, args, outs, t0, layout.size)


def _fake_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _fake_tree(v, dev) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=dev)


def run_cells(archs, shapes, meshes, *, mode="baseline", out_dir=RESULTS_DIR,
              force=False, policy=None, q_override=None, tag="",
              device="cuda", breakdown=False):
    os.makedirs(out_dir, exist_ok=True)
    failures, done = [], 0
    for mesh_name in meshes:
        layout = (production_layout(multi_pod=(mesh_name == "multi"))
                  if mode == "baseline" else
                  pipeline_layout(multi_pod=(mesh_name == "multi")))
        with fake_process_group(layout.size):
            for arch in archs:
                cfg = get_config(arch)
                for shape in shapes:
                    if not supports_shape(cfg, shape):
                        print(f"SKIP {arch} x {shape} (N/A: full attention "
                              f"at 500k) ")
                        continue
                    if mode == "pipeline" and shape != "train_4k":
                        continue
                    suffix = f"_{tag}" if tag else ""
                    fname = os.path.join(
                        out_dir, f"{arch}__{shape}__{mesh_name}"
                                 f"{'_pipe' if mode == 'pipeline' else ''}"
                                 f"{suffix}.json")
                    if os.path.exists(fname) and not force:
                        print(f"CACHED {arch} x {shape} x {mesh_name}")
                        done += 1
                        continue
                    try:
                        if mode == "pipeline":
                            rec = _lower_pipeline_cell(
                                arch, layout, num_stages=layout.shape["stage"],
                                q=q_override or 16, device=device,
                                breakdown=breakdown)
                        else:
                            rec = _lower_cell(arch, shape, layout,
                                              policy=policy,
                                              q_override=q_override,
                                              device=device,
                                              breakdown=breakdown)
                        with open(fname, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"OK {arch} x {shape} x {mesh_name}: "
                              f"hbm/dev={rec['hbm_per_device']/2**30:.2f}GiB "
                              f"flops/dev={rec['flops_per_device']:.3e} "
                              f"coll/dev="
                              f"{rec['collective_bytes_per_device']/2**20:.1f}"
                              f"MiB ({rec['lower_compile_seconds']}s)",
                              flush=True)
                        done += 1
                    except Exception as e:
                        failures.append((arch, shape, mesh_name, repr(e)))
                        print(f"FAIL {arch} x {shape} x {mesh_name}: {e!r}",
                              flush=True)
                        traceback.print_exc()
    print(f"\n{done} cells OK, {len(failures)} failures")
    for f in failures:
        print("  FAIL:", *f)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "pipeline"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for result files "
                    "(perf-iteration variants)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda: the kernels' fake "
                    "branches; cpu: the plain versions)")
    ap.add_argument("--breakdown", action="store_true",
                    help="record what is alive at the memory peak, by the "
                    "op that made it (peak_temp_by_op), and the FLOPs by "
                    "product (flops_by_op)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    policy = shlib.ShardingPolicy(fsdp=not args.no_fsdp)
    failures = run_cells(archs, shapes, meshes, mode=args.mode,
                         out_dir=args.out, force=args.force, policy=policy,
                         q_override=args.microbatches, tag=args.tag,
                         device=args.device, breakdown=args.breakdown)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
