"""The MoE configs ``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b``
(reduced: 2 layers, d_model 64, 4 query heads and 2 kv heads of 16, d_ff
64, vocab 384; 5 experts top-2 and 8 experts top-2) through the port's
transformer, against the reference's, from the same numpy-made weights
(``tests/test_torch_dense_options.py``'s helpers: the reference's layout,
the experts under ``layers["moe"]``), in float32 compute:

* a 72-token prefill (last-position logits and the whole KV cache) and 8
  decode steps after it, within atol = rtol = 1e-4;
* the mean loss (rtol 1e-5) and every gradient (1e-4 of its tensor's
  largest magnitude), the router's and the experts' among them;
* the ``params_from_jax`` / ``params_to_jax`` round trip (``==``);
* the stacked stage path: ``stack_stage_params`` / ``unstack_stage_params``
  over the nested layers ``==`` the reference's, and
  ``transformer_stage_fn`` over 2 stages ``==`` ``forward_hidden``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.pipeline import stage as r_stage
from test_torch_dense_options import (check_serving, check_training,
                                      configs, reference_tree)

from repro_torch.models import transformer
from repro_torch.pipeline import stage
from repro_torch.utils import tree_map

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
MOE = ("router", "w_down", "w_gate", "w_up")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the reduced models' small CPU ops gain
    nothing from a thread pool, and parallel test workers each spinning a
    full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = reference_tree(configs(arch)[0], seed=2)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_serving_matches_reference(arch, trees):
    rcfg, pcfg = configs(arch)
    check_serving(rcfg, pcfg, trees(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_and_gradients_match_reference(arch, trees):
    rcfg, pcfg = configs(arch)
    names = check_training(rcfg, pcfg, trees(arch), S=48)
    assert {f"layers/moe/{n}" for n in MOE} <= set(names)
    assert not {"layers/w_gate", "layers/w_up", "layers/w_down"} & set(names)
    assert ("lm_head" in names) == (not pcfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, trees):
    _, pcfg = configs(arch)
    tree = trees(arch)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    assert set(tree["layers"]["moe"]) == set(MOE)
    back = transformer.params_to_jax(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_path_over_two_stages(arch, trees):
    _, pcfg = configs(arch)
    tree = trees(arch)
    want_stages = r_stage.stack_stage_params(tree["layers"], 2)
    layers = tree_map(torch.from_numpy, tree["layers"])
    stages = stage.stack_stage_params(layers, 2)
    got = dict(jax.tree_util.tree_flatten_with_path(
        tree_map(lambda t: t.numpy(), stages))[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want_stages)[0]
    assert len(got) == len(flat_want)
    for path, a in flat_want:
        assert np.array_equal(got[path], np.asarray(a)), path
    back = stage.unstack_stage_params(stages)
    for path, a in jax.tree_util.tree_flatten_with_path(layers)[0]:
        b = back
        for key in path:
            b = b[key.key]
        assert torch.equal(b, a), path

    model = transformer.params_from_jax(tree, pcfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, pcfg.vocab, size=(2, 24)))
    fn = stage.transformer_stage_fn(pcfg)
    with torch.no_grad():
        want = transformer.forward_hidden(model, tokens)
        x = model.embed_tokens(tokens)
        for s in range(2):
            x = fn(tree_map(lambda v: v[s], stages), x)
    assert torch.equal(x, want)
