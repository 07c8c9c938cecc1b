"""The dry run's memory per device (``utils/cost.py``'s peak of live bytes,
``launch/dryrun.py``'s ``--breakdown``).

The counter's peak was right; what it counted was not what XLA holds.
The cross entropy of vocab-split logits ran as DTensor ops: the gather's
backward scattered into zeros of the micro-batch's whole logits on every
rank (DTensor's ``new_zeros`` of another size is replicated), the sum's
backward cast a whole-vocabulary copy on every rank, and the per-token
terms' gradients came back split over the sequence, an all-to-all that a
fake CPU group runs as an all-gather.  The port's production qwen3-0.6b
``train_4k`` predicted 42.73 GiB a device on 16x16.  The terms now come
from each rank's vocab block (``models/common.py::_terms_on_mesh``).

The prefill's caches are built from their specs on the meta device
(``models/common.py::mesh_zeros``): shapes without storage, which the
counter now leaves out (it counted qwen3-0.6b ``prefill_32k``'s two
whole-batch spec caches, 112 GiB).

Held here: the breakdown groups what is alive at the peak by the op that
made it, and leaves out meta tensors; and on qwen3-0.6b reduced with a
vocabulary of 4096 and a batch of 8 x 256 in Q = 2 (data 2 x model 2),
nothing alive at the peak is larger than a rank's block of the logits
(its rows by half the vocabulary), and the peak above the arguments is
under 12 MB (22.3 MB before the change, 10.9 MB after).
"""

import dataclasses

import pytest
import torch

VOCAB, BATCH, SEQ = 4096, 8, 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_breakdown_names_what_is_alive_at_the_peak():
    from repro_torch.utils.cost import CostCounter
    c = CostCounter(track_memory=True, breakdown=True)
    x = torch.ones(1000)
    c.mark_arguments(x)
    with c:
        big = torch.zeros(3000)
        small = x * 2
        del big
        y = small + 1
        # a spec on the meta device holds no memory
        spec = torch.zeros(10**6, device="meta")
    rows = {r["op"]: r for r in c.peak_by_op()}
    assert rows["aten.zeros"] == {"op": "aten.zeros", "shape": [3000],
                                  "dtype": "torch.float32", "count": 1,
                                  "bytes": 12000}
    assert rows["aten.mul"]["bytes"] == 4000
    assert c.peak_temp_bytes == 16000
    assert y.shape == (1000,) and spec.shape == (10**6,)
    assert "aten.zeros" in rows and c.ops.get("zeros") == 1


def test_the_logits_stay_in_their_vocab_blocks_at_the_peak():
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshLayout
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              vocab=VOCAB)
    layout = MeshLayout(("data", "model"), (2, 2))
    with dryrun.fake_process_group(layout.size):
        rec = dryrun._lower_cell("qwen3-0.6b", "train_4k", layout,
                                 q_override=2, device="cpu", cfg=cfg,
                                 batch_override=(BATCH, SEQ), breakdown=True)
    rows = rec["peak_temp_by_op"]
    block = (BATCH // 2 // 2) * SEQ * (VOCAB // 2)
    for r in rows:
        n = 1
        for s in r["shape"]:
            n *= s
        assert n <= block, r
    assert rec["memory"]["temp_size_in_bytes"] < 12e6
