"""The port's dry run where the query heads do not split over the "model"
axis, against the reference: the keys' sequence splits over "model"
instead (``repro/models/common.py::_kv_seq_spec``;
``repro_torch/models/transformer.py::attention_layout``,
``kernels/flash/split.py``).

The cells: qwen1.5-4b reduced with 6 query and 6 kv heads of 16 (d 64),
a batch of 8 x 32 on a (data 2 x model 4) mesh: 6 heads over 4.  The
reference lowers each in a subprocess on 8 host devices
(``tests/dryrun_reference.py``); the port traces rank 0 on fake CPU tensors,
where each model rank runs the plain attention on its block of the keys,
S x T / 4, as XLA does.  The prefill is held equal (``==``) to XLA's FLOPs
and argument bytes per device.  The training step (Q = 2, remat "none")
takes XLA's argument bytes; its FLOPs are 1.091x XLA's, which lays the
q / k / v projections out with the tokens over "model" (the keys' split
propagated back into them) where the port splits their columns (q's
whole: its heads do not split): held under 1.1x XLA's, and under the
whole attention on every model rank that the port ran before.
"""

import pytest
import torch

from test_torch_dryrun import _check_record
from test_torch_dryrun_multipod import port_cell, records, reference_cells

OVER = {"n_heads": 6, "n_kv": 6}
PREFILL = {"arch": "qwen1.5-4b", "shape": "prefill_32k",
           "axes": ["data", "model"], "sizes": [2, 4], "batch": [8, 32],
           "over": OVER}
TRAIN = {**PREFILL, "shape": "train_4k", "q": 2,
         "over": {**OVER, "remat": "none"}}
#: the training cell's FLOPs a device with every model rank running the
#: whole attention (the port before the keys' split)
WHOLE_ATTENTION_FLOPS = 35389440.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells():
    """{shape: (the port's record, the reference's)}."""
    proc = reference_cells([PREFILL, TRAIN])
    try:
        port = [port_cell(c) for c in (PREFILL, TRAIN)]
        return dict(zip(("prefill", "train"), zip(port, records(proc))))
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("shape", ["prefill", "train"])
def test_split_keys_take_the_references_argument_bytes(cells, shape):
    port, ref = cells[shape]
    _check_record(port)
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]


def test_split_keys_prefill_counts_the_references_flops(cells):
    port, ref = cells["prefill"]
    assert port["flops_per_device"] == ref["flops_per_device"]
    # the keys' split sums the blocks' softmaxes over "model"
    assert port["collective_breakdown"].get("all-reduce", 0) > 0


def test_split_keys_training_step_splits_the_attention(cells):
    port, ref = cells["train"]
    print(f"port {port['flops_per_device']}, reference "
          f"{ref['flops_per_device']}")
    assert port["flops_per_device"] < 1.1 * ref["flops_per_device"]
    assert port["flops_per_device"] < WHOLE_ATTENTION_FLOPS


def test_split_keys_attention_is_a_block_of_the_keys_per_rank():
    """The attention's products on rank 0: S x T / 4 scores a head."""
    from repro_torch.kernels.flash.split import key_blocks
    assert key_blocks(32, 4) == [(0, 8), (8, 16), (16, 24), (24, 32)]
    assert key_blocks(13, 4) == [(0, 4), (4, 8), (8, 12), (12, 13)]
    assert key_blocks(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
