"""The port's link codecs against the reference's.

The same numpy-made float32 inputs go through ``repro.compression`` (jax)
and ``repro_torch.compression``.  int8: the codes, the scale and the
decoded tensor are equal bit for bit (one max, one division, a round half
to even, a clip and a product, each exactly rounded).  top-k: ``lax.top_k``
and ``torch.topk`` may order equal magnitudes differently, so the inputs
are continuous random draws and the densified tensors (and the kept value
sets) are compared.  A training round with int8 link hooks is held to the
reference's round in ``test_torch_train.py``, beside the plain round.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.compression import codecs as RC

import repro_torch.core as T
from repro_torch.compression import (ErrorFeedback, compressed_bytes,
                                     int8_dequantize, int8_quantize,
                                     make_link_hooks, topk_densify,
                                     topk_sparsify)
from repro_torch.pipeline import LinkHooks

#: (shape, scale) of the seeded float32 inputs: a vector, a VGG cut-layer
#: activation (NHWC), a small matrix, a wide range of magnitudes
INPUTS = [((64,), 1.0), ((4, 32, 32, 64), 3.0), ((7, 10), 0.01),
          ((1000,), 100.0)]


def _draw(shape, scale, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,scale", INPUTS)
def test_int8_roundtrip_equals_reference_bitwise(shape, scale):
    x = _draw(shape, scale)
    rq, rs = RC.int8_quantize(jnp.asarray(x))
    q, s = int8_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    want = np.asarray(RC.int8_dequantize(rq, rs))
    assert np.array_equal(int8_dequantize(q, s).numpy(), want)
    assert np.abs(want - x).max() <= np.abs(x).max() / 127.0 + 1e-6


@pytest.mark.parametrize("shape,scale", INPUTS)
def test_topk_keeps_the_reference_entries(shape, scale):
    x = _draw(shape, scale, seed=1)
    k = max(1, x.size // 20)
    rv, ri = RC.topk_sparsify(jnp.asarray(x), k)
    v, i = topk_sparsify(torch.from_numpy(x), k)
    assert sorted(v.tolist()) == sorted(np.asarray(rv).tolist())
    assert sorted(i.tolist()) == sorted(np.asarray(ri).tolist())
    got = topk_densify(v, i, x.shape).numpy()
    assert np.array_equal(got, np.asarray(RC.topk_densify(rv, ri, x.shape)))
    assert np.count_nonzero(got) == k


def test_error_feedback_residual_equals_reference():
    """Round by round, the decoded tensor and the residual equal the
    reference's (top-1 of a 4-vector, as the reference's own test)."""
    x = np.asarray([0.3, -0.7, 0.05, 0.9], np.float32)
    ref, port = RC.ErrorFeedback(), ErrorFeedback()
    total = torch.zeros(4)
    for _ in range(40):
        want = ref.compress(jnp.asarray(x), lambda v: RC.topk_sparsify(v, 1),
                            lambda p: RC.topk_densify(*p, x.shape))
        got = port.compress(torch.from_numpy(x),
                            lambda v: topk_sparsify(v, 1),
                            lambda p: topk_densify(*p, x.shape))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(port.residual.numpy(),
                              np.asarray(ref.residual))
        total += got
    np.testing.assert_allclose((total / 40).numpy(), x, atol=0.05)


def test_compressed_bytes_model():
    for codec in ("none", "int8", "topk"):
        assert compressed_bytes(1000.0, codec) == \
            RC.compressed_bytes(1000.0, codec)
    assert compressed_bytes(1000.0, "topk", topk_ratio=0.05) == 100.0
    with pytest.raises(ValueError):
        compressed_bytes(1.0, "nope")


@pytest.mark.parametrize("codec", ["int8", "topk", "none"])
def test_link_hooks_are_straight_through(codec):
    """Forward: the decoded tensor; backward: the identity."""
    hooks = make_link_hooks(codec)
    assert isinstance(hooks, LinkHooks)
    x = torch.from_numpy(_draw((4, 8), 2.0, seed=3)).requires_grad_()
    y = hooks.fwd(x)
    if codec == "int8":
        want = int8_dequantize(*int8_quantize(x.detach()))
    elif codec == "topk":
        want = topk_densify(*topk_sparsify(x.detach(), 1), x.shape)
    else:
        want = x.detach()
    assert torch.equal(y.detach(), want)
    (y * torch.arange(32.0).reshape(4, 8)).sum().backward()
    assert torch.equal(x.grad, torch.arange(32.0).reshape(4, 8))
    with pytest.raises(ValueError):
        make_link_hooks("nope").fwd(x)


def test_compression_shifts_planner_bottleneck():
    """The port's planner sees compressed links as the reference's does:
    int8 traffic (D_k / 4) never lengthens the plan, and both packages
    give the same plans."""
    prof = T.vgg16_profile(work_units="bytes")
    comp = dataclasses.replace(prof, act_bytes=prof.act_bytes / 4.0,
                               grad_bytes=prof.grad_bytes / 4.0)
    net = T.make_edge_network(num_servers=4, seed=2, kappa=1 / 32.0,
                              bw_range_hz=(10e6, 20e6))
    p0 = T.ours(prof, net, B=256, device="cpu")
    p1 = T.ours(comp, net, B=256, device="cpu")
    assert p1.L_t <= p0.L_t * (1 + 1e-9)
    rprof = R.vgg16_profile(work_units="bytes")
    rcomp = dataclasses.replace(rprof, act_bytes=rprof.act_bytes / 4.0,
                                grad_bytes=rprof.grad_bytes / 4.0)
    rnet = R.make_edge_network(num_servers=4, seed=2, kappa=1 / 32.0,
                               bw_range_hz=(10e6, 20e6))
    r1 = R.ours(rcomp, rnet, B=256)
    assert (p1.solution.cuts, p1.solution.placement, p1.b, p1.L_t) == \
        (r1.solution.cuts, r1.solution.placement, r1.b, r1.L_t)
