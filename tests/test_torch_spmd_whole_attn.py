"""The port's stage pipeline with a "model" axis whose heads do not split
over it (``repro_torch/pipeline/spmd.py``, ``models/transformer.py::
attention_split``), in four spawned gloo ranks on the CPU, as
``tests/test_torch_spmd_tp.py`` spawns them, against the reference.

qwen3-0.6b reduced to 2 layers (4 query and 2 kv heads, qk-norm) in
float32 over (stage 1 x model 4), a batch of 8 x 16 in Q = 2: the 2 kv
heads do not split over 4, and ``PipelineConfig(whole_attention=True)``
(the dry run's layout) has every model rank run the whole attention
(its leaves, the qk-norm scales among them, whole on each rank, their
gradient whole) and its quarter of the FFN.  The loss within 1e-5 and
every gradient within 1e-4 (absolute) of the reference's plain
``api.loss`` / ``jax.grad``, each model rank's gradient against its block
of the reference's (the attention's whole).
"""

import pytest

from test_torch_spmd import check_grads, check_loss, spawn

MODELS = {"qwen3-0.6b": 2}
PIPELINES = [{"tag": "whole_attn", "arch": "qwen3-0.6b",
              "axes": ["stage", "model"], "sizes": [1, 4], "stages": 1,
              "q": 2, "whole_attention": True}]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd_whole_attn"), MODELS,
                 PIPELINES, [], [])


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_whole_attention_loss_matches_the_references_plain_loss(run, case):
    check_loss(run, case)


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_whole_attention_gradients_match_jax_grad(run, case):
    check_grads(run, case)
