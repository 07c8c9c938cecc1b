"""The port's dry run of MoE cells whose micro-batch has fewer rows than the
data ranks (``repro_torch/models/moe.py::_moe_stationary``), against the
reference's lowering of the same reduced cells.

On a (pod 2 x data 2 x model 2) mesh the rows of a micro-batch are
replicated over the 4 (pod, data) ranks, so the reference's hints drop
the dispatch buffer's batch entry and XLA keeps each expert weight's FSDP
block in place, multiplying it by the matching slice of the buffer (its
compiled step lists qwen3-moe-235b's expert products as [4, 16, 64] x
[4, 16, 24]: 4 experts a model rank, a quarter of d = 64).  The port lays
them out the same way; before, every data rank ran every product of its
experts on the whole micro-batch (2.457x and 2.517x the reference's FLOPs
a device under remat "none" and "layer", 3.690x at decode, 1.997x for
jamba-1.5-large's batch-1 decode).  Held here, FLOPs a device over the
reference's:

- qwen3-moe-235b ``train_4k``, 8 x 32 in Q = 4 (2 rows over 4 data
  ranks), remat "none" and "layer": equal;
- qwen3-moe-235b ``decode_32k``, 2 x 64: at most 1.03 (the expert
  products equal; the rest is the decode attention's probabilities times
  v, which XLA splits further);
- jamba-1.5-large ``long_500k``, 1 x 256: at most 1.03 (its 4 slices of
  d_ff are taken from each data rank's block of w_down, where XLA's scan
  gathers each slice, so the port counts less there);
- the controls, no higher than before: qwen3-moe-235b with Q = 2 (the rows
  split over the data ranks) and granite-moe-3b (5 experts do not divide
  "model": each expert's d_ff split, no FSDP, so XLA too runs them whole
  over the data ranks).

Argument bytes as before (equal to the reference's in the train cells).
The reference lowers the cells in two subprocesses while the port traces
(``tests/dryrun_reference.py``).
"""

import pytest
import torch

from test_torch_dryrun import _check_record
from test_torch_dryrun_multipod import port_cell, records, reference_cells

QWEN = {"arch": "qwen3-moe-235b-a22b", "shape": "train_4k",
        "axes": ["pod", "data", "model"], "sizes": [2, 2, 2],
        "batch": [8, 32], "q": 4, "over": {"remat": "none"}}
CELLS = {
    "train_none": QWEN,
    "train_layer": {**QWEN, "over": {"remat": "layer"}},
    "decode": {**QWEN, "shape": "decode_32k", "batch": [2, 64], "over": {}},
    "jamba_long": {"arch": "jamba-1.5-large-398b", "shape": "long_500k",
                   "axes": ["pod", "data", "model"], "sizes": [2, 2, 2],
                   "batch": [1, 256]},
    "rows_split": {**QWEN, "q": 2},
    "granite": {**QWEN, "arch": "granite-moe-3b-a800m"},
}
#: the cells the layout repairs: the largest ratio to the reference's
#: FLOPs a device (1.0: equal)
RATIO = {"train_none": 1.0, "train_layer": 1.0, "decode": 1.03,
         "jamba_long": 1.03}
#: the controls' FLOPs a device before this layout
CONTROL = {"rows_split": 2.5559040e7, "granite": 6.3897600e7}
#: argument bytes where they differ from the reference's (4 bytes fewer,
#: as before this layout); the other cells equal it
ARGS = {"decode": 104200, "jamba_long": 297092}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells():
    """{name: (the port's record, the reference's)} of every cell (the
    reference's in two subprocesses, each lowering half the cells)."""
    names = list(CELLS)
    halves = (names[0::2], names[1::2])
    procs = [reference_cells([CELLS[n] for n in h]) for h in halves]
    try:
        port = {n: port_cell(c) for n, c in CELLS.items()}
        ref = {}
        for h, proc in zip(halves, procs):
            ref.update(zip(h, records(proc)))
        return {n: (port[n], ref[n]) for n in names}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()


@pytest.mark.parametrize("name", list(RATIO))
def test_the_experts_count_the_references_flops(cells, name):
    port, ref = cells[name]
    _check_record(port)
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(f"{name}: port {port['flops_per_device']}, reference "
          f"{ref['flops_per_device']}, {ratio:.4f}")
    if RATIO[name] == 1.0:
        assert port["flops_per_device"] == ref["flops_per_device"]
    else:
        assert ratio <= RATIO[name]


@pytest.mark.parametrize("name", list(CONTROL))
def test_the_controls_count_no_more_than_before(cells, name):
    port, ref = cells[name]
    _check_record(port)
    assert port["flops_per_device"] <= CONTROL[name]
    assert port["flops_per_device"] / ref["flops_per_device"] < 1.02


@pytest.mark.parametrize("name", list(CELLS))
def test_the_argument_bytes_stay(cells, name):
    port, ref = cells[name]
    want = ARGS.get(name, ref["memory"]["argument_size_in_bytes"])
    assert port["memory"]["argument_size_in_bytes"] == want
