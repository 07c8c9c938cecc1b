"""The port's VGG-16 against the reference: weight layout, initializer,
per-layer forward and cross entropy, on the same numpy-made inputs.

The per-layer forward is held within atol 1e-5 in float32, scaled by the
layer's largest activation where that exceeds 1: XLA and PyTorch's CPU
kernels sum the convolutions (up to 4608 terms) in different orders, and
the rounding error of a float32 sum grows with the size of its terms
(activations reach ~10 here, where the errors reach ~1.7e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as r_common
from repro.models import vgg as r_vgg
from test_torch_train import reference_layout_params

from repro_torch.models import common, vgg


@pytest.fixture(scope="module")
def ref_params():
    return reference_layout_params(seed=1)


def test_params_from_jax_round_trips(ref_params):
    layers = vgg.params_from_jax(ref_params)
    back = vgg.params_to_jax(layers)
    for a, b in zip(ref_params, back):
        assert a["w"].shape == b["w"].shape
        assert np.array_equal(a["w"], b["w"])
        assert np.array_equal(a["b"], b["b"])
    assert layers[0].weight.shape == (64, 3, 3, 3)       # OIHW
    assert layers[15].weight.shape == (10, 4096)         # (out, in)


def test_port_initializer_is_seeded_and_shaped_like_reference(ref_params):
    a = vgg.init_params(torch.Generator().manual_seed(3))
    got = vgg.params_to_jax(a)
    for p, r in zip(got, ref_params):
        assert p["w"].shape == r["w"].shape and p["b"].shape == r["b"].shape
    # seeded: the first layer is the generator's first draw, scaled
    w0 = torch.empty(64, 3, 3, 3)
    torch.nn.init.trunc_normal_(w0, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0].weight.detach(), w0 * (np.sqrt(2) / 3 / np.sqrt(3)))
    # the reference's scales: a +-2 std truncated normal has std 0.8796
    w0, w15 = got[0]["w"], got[15]["w"]
    assert np.std(w0) == pytest.approx(0.8796 * np.sqrt(2) / 3 / np.sqrt(3),
                                       rel=0.1)
    assert np.std(w15) == pytest.approx(0.8796 / np.sqrt(4096), rel=0.05)


def test_per_layer_forward_matches_reference(ref_params):
    layers = vgg.params_from_jax(ref_params)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    for i in range(len(vgg.LAYERS)):
        want = np.asarray(r_vgg.layer_fwd(i, ref_params[i], jnp.asarray(x)))
        with torch.no_grad():
            got = vgg.layer_fwd(i, layers, torch.tensor(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
        x = want                      # every layer starts from the same input


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, size=(3, 5)).astype(np.int32)
    labels[0, :2] = -1                                  # ignored positions
    want = float(r_common.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = float(common.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
