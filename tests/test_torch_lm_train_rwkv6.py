"""RWKV6 training through the port against the reference: the reduced
``rwkv6-1.6b``'s ``ModelAPI.loss`` and every parameter's gradient against
``jax.value_and_grad(api.loss)`` under ``remat`` none, layer and dots, from
the same weights in float32 compute (the loss within rtol 1e-5, each
gradient within 1e-4 of its tensor's largest magnitude).  The checks and
their helpers are ``tests/test_torch_lm_train.py``'s."""

import pytest

from test_torch_lm_train import (_one_intra_op_thread,  # noqa: F401
                                 check_loss_and_gradients, weights)


@pytest.mark.parametrize("remat", ["none", "layer", "dots"])
def test_rwkv6_loss_and_gradients_match_jax(remat, weights):  # noqa: F811
    check_loss_and_gradients("rwkv6-1.6b", remat, weights)
