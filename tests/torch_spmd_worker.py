"""One rank of ``tests/test_torch_spmd.py``: the port's stage pipeline, its
train step, sharded checkpoints' reshards (a DTensor's, and the pipeline's
blocks and AdamW state across meshes) and DTensor's splits, on the CPU
under gloo.  Imports no JAX (the ranks stand for the card's processes).

    python tests/torch_spmd_worker.py RANK WORLD DIR

reads ``DIR/job.json`` (the configs and what to run: a model is an arch
at a depth, or ``{"arch", "layers", "over"}``, its config's fields
replaced) and ``DIR/weights_<model>.npz`` (each reference's parameter
tree, flat ``a/b`` keys, and the batch), meets
the other ranks through a ``FileStore`` under ``DIR`` and writes
``DIR/out_<RANK>.npz``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, build_mesh  # noqa: E402
from repro_torch.launch.sharding import (NamedSharding,  # noqa: E402
                                         opt_sharding_tree)
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.pipeline.spmd import (PipelineConfig,  # noqa: E402
                                       as_dtensors, make_pipelined_loss,
                                       make_pipelined_train_step,
                                       param_shardings, shard_params)
from repro_torch.utils import tree_map  # noqa: E402

CPU = "cpu"


def nested(flat: dict) -> dict:
    tree = {}
    for key, a in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(a)
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def pipeline_case(tag, cfg, params, batch, layout, pcfg, out):
    mesh = build_mesh(layout, CPU)
    local = shard_params(params, mesh, pcfg, CPU, cfg=cfg)
    loss_fn = make_pipelined_loss(cfg, mesh, pcfg, CPU)
    loss = loss_fn(local, batch)
    leaves = flat(local)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out[f"{tag}/loss"] = loss.detach().numpy()
    out[f"{tag}/data"] = np.array(loss_fn.pipe.d)
    out[f"{tag}/stage"] = np.array(loss_fn.pipe.k)
    out[f"{tag}/model"] = np.array(loss_fn.pipe.m)
    out[f"{tag}/transport"] = np.array(loss_fn.pipe.transport)
    out[f"{tag}/tp_bytes"] = np.array(loss_fn.pipe.bytes["tp_reduce"])
    for key, g in zip(leaves, grads):
        out[f"{tag}/grad/{key}"] = g.numpy()


def train_case(tag, cfg, params, batch, layout, pcfg, lr, out):
    mesh = build_mesh(layout, CPU)
    local = shard_params(params, mesh, pcfg, CPU, cfg=cfg)
    opt = get_optimizer("adamw", lr=lr)
    state = opt.init(local)
    step = make_pipelined_train_step(cfg, mesh, pcfg, opt, CPU)
    local, state, metrics = step(local, state, batch)
    out[f"{tag}/loss"] = metrics["loss"].numpy()
    for key, p in flat(local).items():
        out[f"{tag}/param/{key}"] = p.detach().numpy()
    for key, t in flat(state).items():
        out[f"{tag}/opt/{key}"] = t.numpy()
    return local, state


def blocks_reshard_case(directory, cfg, whole, local, state, layouts,
                        out):
    """A rank's pipeline blocks and AdamW state, sharded by the first of
    ``layouts`` ((axes, sizes, stages) each), saved whole through
    DTensors, restored onto the second layout's blocks, saved from there
    and restored onto the first's again."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    like = {"params": whole,
            "opt": {"m": whole, "v": whole,
                    "t": torch.zeros((), dtype=torch.int32)}}

    def shardings(layout, stages):
        mesh = build_mesh(MeshLayout(*layout), CPU)
        p = param_shardings(whole, mesh, PipelineConfig(stages, 1), cfg=cfg)
        return {"params": p,
                "opt": opt_sharding_tree(mesh, "adamw", p, whole)}

    there, back = (shardings(lay[:2], lay[2]) for lay in layouts)
    ckpt = os.path.join(directory, "ckpt_blocks")
    tree = {"params": local, "opt": state}
    for step, (src, dst, tag) in enumerate(((there, back, "there"),
                                            (back, there, "back"))):
        save_checkpoint(ckpt, step, as_dtensors(tree, src))
        got, _ = restore_checkpoint(ckpt, step, like, shardings=dst,
                                    device=CPU)
        tree = tree_map(lambda t: t.to_local(), got)
        for key, t in flat(tree).items():
            out[f"ckpt/{tag}/{key}"] = t.numpy()


def reshard_case(directory, out):
    """A (4,) "model" mesh's DTensor saved, restored onto (2, 2)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.sharding import placements
    mesh4 = build_mesh(MeshLayout(("model",), (4,)), CPU)
    x = torch.arange(32.0).reshape(8, 4)
    dx = distribute_tensor(x, mesh4, placements(("model", None), mesh4),
                           src_data_rank=None)
    ckpt = os.path.join(directory, "ckpt")
    save_checkpoint(ckpt, 0, {"x": dx})
    mesh22 = build_mesh(MeshLayout(("data", "model"), (2, 2)), CPU)
    sh = {"x": NamedSharding(mesh22, (None, "model"))}
    got, meta = restore_checkpoint(ckpt, 0, {"x": torch.zeros(8, 4)},
                                   shardings=sh, device=CPU)
    out["reshard/saved_local"] = dx.to_local().numpy()
    out["reshard/local"] = got["x"].to_local().numpy()
    out["reshard/placements"] = np.array(repr(tuple(got["x"].placements)))
    out["reshard/full"] = got["x"].full_tensor().numpy()
    out["reshard/step"] = np.array(meta["step"])


def split_case(splits, out):
    """Each rank's block of an arange tensor under DTensor's placements of
    the given specs."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.sharding import placements
    for i, (names, sizes, spec, shape) in enumerate(splits):
        mesh = build_mesh(MeshLayout(tuple(names), tuple(sizes)), CPU)
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        x = torch.arange(int(np.prod(shape))).reshape(shape)
        local = distribute_tensor(x, mesh, placements(spec, mesh),
                                  src_data_rank=None).to_local()
        out[f"split/{i}"] = local.numpy()


def mesh_size_case(out):
    """A layout whose size is not the world size raises."""
    try:
        build_mesh(MeshLayout(("data",), (3,)), CPU)
        out["mesh_size_error"] = np.array("")
    except ValueError as e:
        out["mesh_size_error"] = np.array(str(e))


def main():
    rank, world, directory = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    models = {}
    for name, spec in job["models"].items():
        if not isinstance(spec, dict):
            spec = {"arch": name, "layers": spec}
        cfg = dataclasses.replace(get_config(spec["arch"], reduced=True),
                                  num_layers=spec["layers"], remat="layer",
                                  compute_dtype=torch.float32,
                                  **spec.get("over", {}))
        with np.load(os.path.join(directory, f"weights_{name}.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        batch = {"tokens": arrays.pop("batch/tokens"),
                 "labels": arrays.pop("batch/labels")}
        models[name] = (cfg, nested(arrays), batch)
    out = {}
    for case in job["pipelines"]:
        pipeline_case(case["tag"], *models[case["arch"]],
                      MeshLayout(tuple(case["axes"]), tuple(case["sizes"])),
                      PipelineConfig(case["stages"], case["q"]), out)
    for case in job["train"]:
        local, state = train_case(
            case["tag"], *models[case["arch"]],
            MeshLayout(tuple(case["axes"]), tuple(case["sizes"])),
            PipelineConfig(case["stages"], case["q"]), job["lr"], out)
        if case.get("reshard"):
            cfg, whole, _ = models[case["arch"]]
            blocks_reshard_case(
                directory, cfg, whole, local, state,
                [(tuple(case["axes"]), tuple(case["sizes"]), case["stages"]),
                 (tuple(case["reshard"]["axes"]),
                  tuple(case["reshard"]["sizes"]),
                  case["reshard"]["stages"])], out)
    reshard_case(directory, out)
    mesh_size_case(out)
    split_case(job["splits"], out)
    np.savez(os.path.join(directory, f"out_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
