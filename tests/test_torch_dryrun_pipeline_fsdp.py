"""The dry run's paper-mode cell (``repro_torch/launch/dryrun.py::
_lower_pipeline_cell``) holds its parameters and AdamW state in the
reference's blocks, on the reduced (data 2 x stage 2 x model 2) cell of
``tests/test_torch_dryrun_pipeline.py``: qwen3-0.6b and internvl2-1b
reduced to 4 layers, a batch of 8 x 32 in Q = 2, remat "none".

Rank 0 holds its stage's layers, each cut to its FSDP block over the 2
data ranks and to its block on "model", and the embedding's vocabulary
block on "model" (no FSDP block); its arguments are those blocks in
float32, AdamW's two moments in the same blocks, the step count and the
batch.  The blocks are cut here by the test's own rule (the helpers of
``tests/test_torch_spmd.py``, independent of ``launch/sharding.py``),
from the whole shapes.  The reference holds every stage's layers at
1 / (D M), gathered at use, so the port's arguments are at or below its
record's (``tests/dryrun_reference.py`` lowers both cells in a subprocess
on 8 host devices).  The gathers and the reduce-scatters of the FSDP
blocks are counted among the collectives, as on NCCL.
"""

import numpy as np
import pytest
import torch

from test_torch_dryrun_multipod import port_cell, records, reference_cells
from test_torch_dryrun_pipeline import ARCHS, CELL, CELLS
from test_torch_spmd import _want


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells():
    proc = reference_cells(CELLS)
    try:
        port = [port_cell(c) for c in CELLS]
        return dict(zip(ARCHS, zip(port, records(proc))))
    finally:
        if proc.poll() is None:
            proc.kill()


def _config(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True),
                               **CELL["over"])


def expected_arguments(arch) -> tuple:
    """(rank 0's parameter and AdamW bytes, its batch's bytes) from the
    shapes: each leaf's block at data 0, stage 0, model 0, in float32,
    three times (the parameter, m and v), and the int32 step count."""
    from repro_torch.configs import SHAPES, param_specs
    from repro_torch.launch.dryrun import _input_specs
    cfg = _config(arch)
    D, S, M = CELL["sizes"]
    whole = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                whole[prefix + k] = np.empty(tuple(v.shape), np.float32)
    walk(param_specs(cfg), "")
    blocks = sum(_want(key, whole, 0, S, 0, M, cfg.moe_experts, 0, D).size
                 for key in whole)
    B, L = CELL["batch"]
    import dataclasses
    sp = dataclasses.replace(SHAPES[CELL["shape"]], global_batch=B,
                             seq_len=L)
    batch = sum(t.numel() * t.element_size()
                for t in _input_specs(cfg, sp).values())
    return 3 * 4 * blocks + 4, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_the_arguments_are_the_rule_blocks_and_their_adamw_state(cells,
                                                                 arch):
    port, ref = cells[arch]
    state, batch = expected_arguments(arch)
    args = port["memory"]["argument_size_in_bytes"]
    print(f"{arch}: port {args}, blocks and AdamW {state} + batch {batch}, "
          f"reference {ref['memory']['argument_size_in_bytes']}")
    assert args == state + batch
    assert args <= ref["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_fsdp_gathers_and_reduce_scatters_are_counted(cells, arch):
    port, _ = cells[arch]
    kinds = port["collective_breakdown"]
    assert kinds.get("all-gather", 0) > 0
    assert kinds.get("reduce-scatter", 0) > 0


def test_the_pipeline_cell_records_what_is_alive_at_its_peak():
    """``--breakdown`` reaches the paper-mode cells: what is alive at the
    peak above the arguments, by the op that made it, and the FLOPs by
    product, summing to the record's temp bytes and FLOPs."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    layout = MeshLayout(tuple(CELL["axes"]), tuple(CELL["sizes"]))
    with dryrun.fake_process_group(layout.size):
        rec = dryrun._lower_pipeline_cell(
            ARCHS[0], layout, num_stages=layout.shape["stage"], q=CELL["q"],
            device="cpu", cfg=_config(ARCHS[0]),
            batch_override=tuple(CELL["batch"]), breakdown=True)
    peak = rec["peak_temp_by_op"]
    assert peak and all(r["bytes"] > 0 for r in peak)
    assert sum(r["bytes"] for r in peak) <= \
        rec["memory"]["temp_size_in_bytes"]
    assert sum(r["flops"] for r in rec["flops_by_op"]) == \
        rec["flops_per_device"]
