"""The port's dry run (``repro_torch/launch/dryrun.py``) where a
micro-batch has fewer rows than the data ranks, against the reference.

The cell: qwen3-0.6b reduced (2 layers, d 64), a batch of 8 x 32 in Q = 4
micro-batches of 2 rows, AdamW, remat "none", on a (pod 2 x data 2 x model
2) mesh.  A micro-batch's 2 rows do not split over the 4 (pod, data)
ranks, so the reference's hints drop its batch entry and XLA keeps each
parameter's FSDP block in place, multiplying it by the matching slice of
the replicated activations (only the attention runs whole over the data
axes); the port lays the products out the same way
(``models/common.py::batch_layout``).  The reference lowers the cell in a
subprocess on 8 host devices (``tests/dryrun_reference.py``); held equal
(``==``): the FLOPs and the argument bytes per device.  The even split
(1.8874e7, the Q = 2 cell's) is below both, and the port's figure before
this layout, every rank computing the whole micro-batch, 4x it.  Under
remat "layer" too: the backward's recompute, which runs outside the
forward's layout, re-enters it (``models/common.py::remat_wrap``).
"""

import json
import subprocess
import sys

import pytest
import torch

from test_torch_dryrun import ROOT, _check_record

CELL = {"arch": "qwen3-0.6b", "shape": "train_4k",
        "axes": ["pod", "data", "model"], "sizes": [2, 2, 2],
        "batch": [8, 32], "q": 4, "over": {"remat": "none"}}
#: the cell under remat "layer"
REMAT = {**CELL, "over": {"remat": "layer"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_cells(cells) -> subprocess.Popen:
    """The reference's records of ``cells`` (``tests/dryrun_reference.py``)
    in a subprocess; read them with :func:`records`."""
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "dryrun_reference.py"),
         json.dumps(cells)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def records(proc) -> list:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def port_cell(c) -> dict:
    """The port's record of a cell in ``tests/dryrun_reference.py``'s
    terms, traced on fake CPU tensors over a fake process group."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    cfg = dataclasses.replace(get_config(c["arch"], reduced=True),
                              **c.get("over", {}))
    layout = MeshLayout(tuple(c["axes"]), tuple(c["sizes"]))
    batch = tuple(c["batch"])
    with dryrun.fake_process_group(layout.size):
        if c.get("pipeline"):
            return dryrun._lower_pipeline_cell(
                c["arch"], layout, num_stages=layout.shape["stage"],
                q=c.get("q", 1), device="cpu", cfg=cfg,
                batch_override=batch)
        return dryrun._lower_cell(c["arch"], c["shape"], layout,
                                  q_override=c.get("q"), device="cpu",
                                  cfg=cfg, batch_override=batch)


@pytest.fixture(scope="module")
def cells():
    """{remat: (the port's record, the reference's)} of both cells."""
    proc = reference_cells([CELL, REMAT])
    try:
        port = [port_cell(c) for c in (CELL, REMAT)]
        return dict(zip(("none", "layer"), zip(port, records(proc))))
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module")
def cell(cells):
    return cells["none"]


def test_small_micro_batches_count_the_references_flops(cell):
    port, ref = cell
    _check_record(port)
    print(f"port {port['flops_per_device']}, reference "
          f"{ref['flops_per_device']}")
    assert port["flops_per_device"] == ref["flops_per_device"]
    # more than the even split of the work, less than each rank running
    # the whole micro-batch
    assert 1.8874368e7 < port["flops_per_device"] < 7.5497472e7


def test_a_remat_recompute_keeps_the_layout(cells):
    port, ref = cells["layer"]
    _check_record(port)
    assert port["flops_per_device"] == ref["flops_per_device"]
    assert port["flops_per_device"] > cells["none"][0]["flops_per_device"]


def test_small_micro_batches_take_the_references_argument_bytes(cell):
    port, ref = cell
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]
    assert port["memory"]["temp_size_in_bytes"] > 0


def test_the_roofline_prints_the_cell_beside_the_references(cell):
    from repro_torch.launch.roofline import compare_table
    port, ref = cell
    table = compare_table([port], [ref])
    row = table.splitlines()[-1]
    assert row.startswith("| qwen3-0.6b | train_4k | 2x2x2 |")
    assert "| 1.0000 |" in row
    # a cell the reference did not lower
    assert "| — | — |" in compare_table([port], []).splitlines()[-1]
