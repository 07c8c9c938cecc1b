"""The stage pipeline's vocabulary-parallel head (``repro_torch/pipeline/
spmd.py::_vocab_parallel_ce``), in four spawned gloo ranks on the CPU, as
``tests/test_torch_spmd_tp.py`` spawns them, against the reference.

Where the reference's rules put the vocabulary on "model" (it divides the
axis: ``repro/launch/sharding.py:79-92``), each model rank computes its
block of the logits from its rows of the tied embedding or its columns of
``lm_head``, and the cross entropy's max, sum of exponentials and gold
logits are summed over the model group; else the head runs whole on
every model rank.  The cells, 2 layers in float32, a batch of 8 x 16,
built by ``dataclasses.replace`` in both packages:
- ``untied``: llama3-8b reduced (untied, vocab 384) over (stage 2 x model
  2), Q = 2;
- ``untied_keys``: the same with 3 / 3 heads (the keys' sequence split
  over the model group too);
- ``padded``: llama3-8b reduced over (data 2 x stage 1 x model 2) in
  Q = 8: one row a micro-batch over two data ranks, the second a padding
  row of label -1, which the vocabulary-parallel loss leaves out;
- ``whole``: qwen3-0.6b reduced (tied) with a vocabulary of 255 over
  (stage 2 x model 2): 255 does not split over 2, the head stays whole.
The loss within 1e-5 and every gradient within 1e-4 (absolute) of the
reference's plain ``api.loss`` / ``jax.grad``.
"""

import pytest

from test_torch_spmd import check_grads, check_loss, spawn

LLAMA = "llama3-8b"
MODELS = {
    "untied": {"arch": LLAMA, "layers": 2},
    "untied_keys": {"arch": LLAMA, "layers": 2,
                    "over": {"n_heads": 3, "n_kv": 3}},
    "whole": {"arch": "qwen3-0.6b", "layers": 2, "over": {"vocab": 255}},
}
PIPELINES = [
    {"tag": "untied", "arch": "untied", "axes": ["stage", "model"],
     "sizes": [2, 2], "stages": 2, "q": 2},
    {"tag": "untied_keys", "arch": "untied_keys",
     "axes": ["stage", "model"], "sizes": [2, 2], "stages": 2, "q": 2},
    {"tag": "padded", "arch": "untied", "axes": ["data", "stage", "model"],
     "sizes": [2, 1, 2], "stages": 1, "q": 8},
    {"tag": "whole", "arch": "whole", "axes": ["stage", "model"],
     "sizes": [2, 2], "stages": 2, "q": 2},
]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd_vocab"), MODELS, PIPELINES,
                 [], [])


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_vocab_parallel_loss_matches_the_references_plain_loss(run, case):
    check_loss(run, case)


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_vocab_parallel_gradients_match_jax_grad(run, case):
    check_grads(run, case)


def test_the_vocabulary_splits_where_the_rules_put_it_on_model():
    from repro_torch.configs import get_config
    from repro_torch.pipeline.spmd import vocab_parallel
    assert vocab_parallel(get_config("qwen3-0.6b"), 2)
    assert vocab_parallel(get_config("qwen3-0.6b"), 4)
    assert not vocab_parallel(get_config("internvl2-1b"), 4)
    assert not vocab_parallel(get_config("qwen3-0.6b"), 1)
