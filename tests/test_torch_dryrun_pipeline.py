"""The dry run's paper-mode cells (``repro_torch/launch/dryrun.py::
_lower_pipeline_cell``) against the reference's, on a (data 2 x stage 2 x
model 2) mesh: qwen3-0.6b and the VLM backbone internvl2-1b (which the
stage pipeline now takes, reading the tokens only as the reference's
does) reduced to 4 layers, a batch of 8 x 32 in Q = 2 micro-batches,
remat "none".

Every product but the head's is counted alike.  The head is laid out
differently, and its FLOPs are held to what each layout computes (from
the shapes, with P = 2 t d V one full-vocabulary head product of a data
rank's t tokens of a micro-batch):

- the port deals the Q micro-batches' heads round-robin over the S stage
  ranks, each with its vocabulary over the M model ranks where it divides
  them (the vocabulary-parallel head, ``pipeline/spmd.py::
  _vocab_parallel_ce``; else whole on every model rank): rank 0 runs
  ceil(Q / S) heads, forward and two backward products, 3 ceil(Q / S) P /
  M;
- the reference runs every micro-batch's head on every stage rank (its
  head is outside the stage region), the vocabulary over the M model
  ranks, and XLA also splits the head's input gradient over the stage
  axis: Q P (2 / M + 1 / (M S)).

At this mesh that is 1.5 P against 2.5 P, one head product a device fewer
(on the production qwen3-0.6b cell on 16x4x4, 3 P against 9 P).  The
reference lowers both cells in a subprocess on 8 host devices
(``tests/dryrun_reference.py``).
"""

import math

import pytest
import torch

from test_torch_dryrun import _check_record
from test_torch_dryrun_multipod import port_cell, records, reference_cells

CELL = {"shape": "train_4k", "axes": ["data", "stage", "model"],
        "sizes": [2, 2, 2], "batch": [8, 32], "q": 2, "pipeline": True,
        "over": {"remat": "none", "num_layers": 4}}
ARCHS = ["qwen3-0.6b", "internvl2-1b"]
CELLS = [{**CELL, "arch": a} for a in ARCHS]


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


def heads(arch) -> tuple:
    """(the port's, the reference's) head FLOPs a device of the cell."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=True)
    D, S, M = CELL["sizes"]
    B, L = CELL["batch"]
    Q = CELL["q"]
    P = 2 * (B // Q // D) * L * cfg.d_model * cfg.vocab
    split = M if cfg.vocab % M == 0 else 1
    return 3 * math.ceil(Q / S) * P / split, Q * P * (2 / M + 1 / (M * S))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_pipeline_cell_traces(cells, arch):
    port, _ = cells[arch]
    _check_record(port)
    assert port["kind"] == "train-pipeline" and port["devices"] == 8
    assert port["collective_breakdown"]["collective-permute"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_the_pipeline_cell_counts_the_references_flops_but_the_heads(
        cells, arch):
    port, ref = cells[arch]
    mine, theirs = heads(arch)
    print(f"{arch}: port {port['flops_per_device']}, reference "
          f"{ref['flops_per_device']}, heads {mine} / {theirs}")
    assert port["flops_per_device"] - mine == \
        ref["flops_per_device"] - theirs
