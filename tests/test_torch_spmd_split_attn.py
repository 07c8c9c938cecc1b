"""The port's stage pipeline with a "model" axis whose heads do not split
into whole heads over it (``repro_torch/models/transformer.py::
attention_mode``, ``kernels/flash/split.py``, ``pipeline/spmd.py``), in
four spawned gloo ranks on the CPU, as ``tests/test_torch_spmd_tp.py``
spawns them, against the reference.

Each config is the reduced qwen3-0.6b (d 64, heads of 16, qk-norm, tied
head, vocab 256) at 2 layers in float32, built by ``dataclasses.replace``
in both packages; a batch of 8 in Q = 2:
- ``keys``: 3 query / 1 kv heads over (stage 2 x model 2): every head
  gathered whole on each model rank, the keys' sequence (16) split in two
  blocks, the blocks' softmaxes combined (the reference's
  ``_kv_seq_spec``); a rank's 24 query columns are 1.5 heads;
- ``shared_kv``: the 4 / 2 heads over (stage 1 x model 4): each rank its
  query head and the kv head it reads, gathered over the group, whose
  gradient the two ranks that read it sum;
- ``ragged``: 3 / 1 heads over (stage 1 x model 4) with a sequence of 13:
  key blocks of 4, 4, 4 and 1;
- ``uneven_groups``: 6 / 3 heads over (stage 2 x model 2): a rank's 3
  query heads read kv heads 0, 0, 1 (or 1, 2, 2), no whole GQA group, so
  it takes one kv head a query head.
The vocabulary (256) splits over "model" in each (the vocabulary-parallel
head).  The loss within 1e-5 and every gradient within 1e-4 (absolute) of
the reference's plain ``api.loss`` / ``jax.grad``, each model rank's
gradient against its block of the reference's (the attention's flat
columns, whole heads or not, cut in the test).
"""

import pytest

from test_torch_spmd import check_grads, check_loss, spawn

QWEN = "qwen3-0.6b"
MODELS = {
    "keys": {"arch": QWEN, "layers": 2, "over": {"n_heads": 3, "n_kv": 1}},
    "shared_kv": {"arch": QWEN, "layers": 2},
    "ragged": {"arch": QWEN, "layers": 2, "over": {"n_heads": 3, "n_kv": 1},
               "seq": 13},
    "uneven_groups": {"arch": QWEN, "layers": 2,
                      "over": {"n_heads": 6, "n_kv": 3}},
}
PIPELINES = [
    {"tag": "keys", "arch": "keys", "axes": ["stage", "model"],
     "sizes": [2, 2], "stages": 2, "q": 2},
    {"tag": "shared_kv", "arch": "shared_kv", "axes": ["stage", "model"],
     "sizes": [1, 4], "stages": 1, "q": 2},
    {"tag": "ragged", "arch": "ragged", "axes": ["stage", "model"],
     "sizes": [1, 4], "stages": 1, "q": 2},
    {"tag": "uneven_groups", "arch": "uneven_groups",
     "axes": ["stage", "model"], "sizes": [2, 2], "stages": 2, "q": 2},
]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd_split_attn"), MODELS,
                 PIPELINES, [], [])


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_unsplit_heads_loss_matches_the_references_plain_loss(run, case):
    check_loss(run, case)


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_unsplit_heads_gradients_match_jax_grad(run, case):
    check_grads(run, case)
