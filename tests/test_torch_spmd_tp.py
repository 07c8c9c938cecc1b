"""The port's stage pipeline with a "model" axis — tensor parallelism
inside a stage (``repro_torch/pipeline/spmd.py``, ``stage.py::
transformer_stage_fn(cfg, tp=...)``, ``models/moe.py``'s two branches) —
in four spawned gloo ranks on the CPU (``tests/torch_spmd_worker.py``, as
``tests/test_torch_spmd.py`` spawns them), against the reference.

Each rank holds its stage's block of layers and, within it, its block of
the heads and FFN columns (or of the experts) by the reference's sharding
rules.  The cases: llama3-8b reduced to 4 layers in float32, a batch of 8
x 16 in Q = 4 micro-batches, over (stage 2 x model 2) and (data 2 x stage
1 x model 2); the MoE branches over (stage 2 x model 2) in Q = 2:
qwen3-moe-235b-a22b reduced (8 experts: expert parallelism, 4 a rank) and
granite-moe-3b-a800m reduced (5 experts: each expert's d_ff split); the
loss within 1e-5 and every gradient within 1e-4 (absolute) of the
reference's plain ``api.loss`` / ``jax.grad`` on the same numpy weights,
each model rank's gradient against its block of the reference's (cut by
Megatron's layout in the test, independently of ``launch/sharding.py``);
one AdamW train step over (stage 2 x model 2), its update the
reference's AdamW on the gradients the pipeline gave.
"""

import pytest

from test_torch_spmd import ARCH, LAYERS, Q, check_grads, check_loss, \
    check_train, spawn

MODELS = {ARCH: LAYERS, "qwen3-moe-235b-a22b": 2, "granite-moe-3b-a800m": 2}
PIPELINES = [
    {"tag": "s2m2", "arch": ARCH, "axes": ["stage", "model"],
     "sizes": [2, 2], "stages": 2, "q": Q},
    {"tag": "d2m2", "arch": ARCH, "axes": ["data", "stage", "model"],
     "sizes": [2, 1, 2], "stages": 1, "q": Q},
    {"tag": "moe_ep", "arch": "qwen3-moe-235b-a22b",
     "axes": ["stage", "model"], "sizes": [2, 2], "stages": 2, "q": 2},
    {"tag": "moe_ff", "arch": "granite-moe-3b-a800m",
     "axes": ["stage", "model"], "sizes": [2, 2], "stages": 2, "q": 2},
]
TRAIN = [{"tag": "train_tp", "arch": ARCH, "axes": ["stage", "model"],
          "sizes": [2, 2], "stages": 2, "q": Q, "grads": "s2m2"}]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd_tp"), MODELS, PIPELINES,
                 TRAIN, [])


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_model_axis_loss_matches_the_references_plain_loss(run, case):
    check_loss(run, case)


@pytest.mark.parametrize("case", PIPELINES, ids=lambda c: c["tag"])
def test_model_axis_gradients_match_jax_grad(run, case):
    check_grads(run, case)


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: c["tag"])
def test_model_axis_train_step_matches_the_references_adamw(run, case):
    check_train(run, case)
