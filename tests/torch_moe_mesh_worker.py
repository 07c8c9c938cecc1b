"""One rank of ``tests/test_torch_moe_mesh.py``: the MoE FFN on DTensors
(``repro_torch/models/moe.py::moe_ffn``'s mesh path, the dry run's
sharded layers) over a (data 2 x model 2) mesh, on real values under
gloo, beside the plain ``moe_ffn`` on the same weights.  Imports no JAX.

    python tests/torch_moe_mesh_worker.py RANK WORLD DIR

reads ``DIR/job.json`` (a list of cases: ``tag``, ``arch``, ``rows``,
``seq``, ``seed``), meets the other ranks through a ``FileStore`` under
``DIR`` and, on rank 0, writes ``DIR/out.npz``: per case the plain output
and gradients (``<tag>/plain/<name>``) and the mesh path's, gathered whole
(``<tag>/mesh/<name>``), the placements the weights and the input had
(``<tag>/placements``), and the FLOPs of the plain call and of rank 0's
share of the mesh call (``<tag>/flops``, ``utils/cost.py``).
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, build_mesh  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.common import batch_layout  # noqa: E402
from repro_torch.utils.cost import CostCounter  # noqa: E402

CPU = "cpu"
LAYOUT = MeshLayout(("data", "model"), (2, 2))
NAMES = ("router", "w_gate", "w_up", "w_down")


def grads(moe, x, gy):
    """moe_ffn(moe, x) and the gradients of <y, gy> for x and each
    parameter (in ``NAMES`` order)."""
    y = moe_lib.moe_ffn(moe, x)
    inputs = [x] + [getattr(moe, n) for n in NAMES]
    return y, torch.autograd.grad(y, inputs, gy)


def whole(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def run_case(case, mesh, out):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cfg = dataclasses.replace(get_config(case["arch"], reduced=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(case["seed"])
    moe = moe_lib.MoEFFN(cfg, CPU)
    moe_lib.init_moe_params(moe, gen)
    shape = (case["rows"], case["seq"], cfg.d_model)
    x = torch.randn(shape, generator=gen).requires_grad_()
    gy = torch.randn(shape, generator=gen)
    y, g = grads(moe, x, gy)
    tag = case["tag"]
    out[f"{tag}/plain/y"] = y.detach().numpy()
    for name, t in zip(("x",) + NAMES, g):
        out[f"{tag}/plain/{name}"] = t.numpy()

    # the same weights placed by the rules (a layer's block of the stacked
    # leaf), the rows split over "data" where they divide it
    on_mesh = moe_lib.MoEFFN(cfg, "meta")
    place = {}
    for name in NAMES:
        p = getattr(moe, name).detach()
        spec = shlib.param_spec(cfg, LAYOUT, f"layers/moe/{name}",
                                (1,) + tuple(p.shape))
        pl = shlib.placements(spec[1:], mesh)
        place[name] = pl
        setattr(on_mesh, name, torch.nn.Parameter(distribute_tensor(
            p, mesh, pl, src_data_rank=None)))
    rows = [Shard(0) if case["rows"] % 2 == 0 else Replicate(), Replicate()]
    xd = distribute_tensor(x.detach(), mesh, rows,
                           src_data_rank=None).requires_grad_()
    gyd = distribute_tensor(gy, mesh, [Replicate(), Replicate()],
                            src_data_rank=None)
    with batch_layout(xd), CostCounter() as counter:
        yd, gd = grads(on_mesh, xd, gyd)
    with CostCounter() as plain:
        grads(moe, x, gy)
    out[f"{tag}/flops"] = np.array([plain.flops, counter.flops])
    out[f"{tag}/mesh/y"] = whole(yd).numpy()
    for name, t in zip(("x",) + NAMES, gd):
        out[f"{tag}/mesh/{name}"] = whole(t).numpy()
    out[f"{tag}/placements"] = np.array(repr(
        {"x": tuple(rows), **{n: tuple(p) for n, p in place.items()}}))


def main():
    rank, world, directory = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    mesh = build_mesh(LAYOUT, CPU)
    out = {}
    for case in job:
        run_case(case, mesh, out)
    if rank == 0:
        np.savez(os.path.join(directory, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
