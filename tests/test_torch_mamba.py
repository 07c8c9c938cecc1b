"""The Mamba block and the chunked linear scan, against the reference's.

``chunked_linear_scan`` (h_t = a_t h_{t-1} + x_t, a log-depth scan inside
each chunk, the carry between chunks) is held to the reference's at
several shapes and chunks, and with a ragged last chunk (the reference
takes only chunks that divide S: there it runs at chunk 1).  The causal
convolution, with and without a tail state, and ``mamba_fwd`` (the
reduced ``jamba-1.5-large`` widths: d_model 64, d_inner 128, d_state 16,
kernel 4; ``scan_chunk`` 16) at S = 1 (the decode step), 37 (odd: the
reference's chunk 1), 64 and 300, from a zero start and from a given
state, take the same numpy-made weights and inputs in both packages, in
float32.  The weights put dt between ~0.05 and ~0.6, so exp(dt A) runs
from near 1 down to ~1e-4: a strong decay.

Tolerances: forward outputs and states within 1e-5 of each tensor's
largest magnitude; gradients of ``mamba_fwd`` (every parameter and the
input, against ``jax.grad``) within 1e-4 (``GRAD_REL``, as
``tests/test_torch_lm_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as RC
from repro.models import mamba as RM

from repro_torch.configs import get_config
from repro_torch.models import mamba
from repro_torch.models.common import chunked_linear_scan

FWD_REL = 1e-5
GRAD_REL = 1e-4
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread: the small CPU ops gain nothing from a
    thread pool, and parallel test workers each spinning a full pool
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch=ARCH, **changes):
    """(reference config, port config) of ``arch``, reduced, float32
    compute, with ``changes``."""
    ref = dataclasses.replace(ref_get_config(arch, reduced=True),
                              compute_dtype=jnp.float32, **changes)
    port = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype=torch.float32, **changes)
    return ref, port


ONES = ("ln1", "ln2", "ln_x", "norm", "final_norm", "q_norm", "k_norm",
        "scale", "D")
ZEROS = ("bq", "bk", "bv", "bo", "b_up", "b_down", "conv_b", "bias")


def fill_tree(shapes, seed=0):
    """numpy weights for the tree of ``jax.ShapeDtypeStruct`` ``shapes``:
    scales near one, biases near zero, ``dt_bias`` near -2, ``A_log``
    near log(1..d_state), embeddings at 0.5 and matrices at
    1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ONES:
            return 1.0 + 0.1 * rng.normal(size=s.shape)
        if name.removeprefix("x_") in ZEROS:
            return 0.1 * rng.normal(size=s.shape)
        if name == "dt_bias":
            return rng.normal(-2.0, 0.5, size=s.shape)
        if name == "A_log":
            return np.log(np.arange(1, s.shape[-1] + 1)) \
                + 0.1 * rng.normal(size=s.shape)
        if name in ("embed", "tok_embed", "dec_pos"):
            return 0.5 * rng.normal(size=s.shape)
        return rng.normal(size=s.shape) / np.sqrt(s.shape[-2])

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float().cpu()) if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def block():
    """(reference config, port config, reference params, port block)."""
    rcfg, pcfg = configs(scan_chunk=16)
    shapes = jax.eval_shape(lambda k: RM.init_mamba_params(k, rcfg),
                            jax.random.PRNGKey(0))
    params = fill_tree(shapes, seed=1)
    m = mamba.Mamba(pcfg, "cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
    return rcfg, pcfg, params, m


@pytest.mark.parametrize("shape,chunk", [((2, 64, 3, 5), 16),
                                         ((1, 48, 7), 48),
                                         ((2, 32, 4, 4), 8),
                                         ((3, 20, 6), 1),
                                         ((2, 37, 5), 16)])
def test_chunked_linear_scan_matches_reference(shape, chunk):
    rng = np.random.default_rng(sum(shape) + chunk)
    a = rng.uniform(0.2, 1.0, size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    h0 = rng.normal(size=(shape[0],) + shape[2:]).astype(np.float32)
    ref_chunk = chunk if shape[1] % chunk == 0 else 1
    w_last, w_all = jax.jit(RC.chunked_linear_scan, static_argnums=3)(
        a, x, h0, ref_chunk)
    got_last, got_all = chunked_linear_scan(
        torch.from_numpy(a), torch.from_numpy(x), torch.from_numpy(h0),
        chunk)
    close(got_all, w_all, FWD_REL)
    close(got_last, w_last, FWD_REL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(block, with_state):
    rcfg, _, params, _ = block
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 128)).astype(np.float32)
    state = rng.normal(size=(2, 3, 128)).astype(np.float32) \
        if with_state else None
    want, w_state = RM._causal_conv(x, params["conv_w"], params["conv_b"],
                                    state)
    got, g_state = mamba.causal_conv(
        torch.from_numpy(x), torch.from_numpy(params["conv_w"]),
        torch.from_numpy(params["conv_b"]),
        None if state is None else torch.from_numpy(state))
    close(got, want, FWD_REL)
    close(g_state, w_state, 0.0)


def _state(rng, B=2):
    return (rng.normal(size=(B, 3, 128)).astype(np.float32),
            rng.normal(size=(B, 128, 16)).astype(np.float32))


@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("S", [1, 37, 64, 300])
def test_mamba_fwd_matches_reference(block, S, from_state):
    rcfg, _, params, m = block
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    state = _state(rng) if from_state else None
    want, (w_conv, w_h) = jax.jit(
        lambda p, x, s: RM.mamba_fwd(p, x, rcfg, state=s))(params, x, state)
    with torch.no_grad():
        got, (conv, h) = mamba.mamba_fwd(
            m, torch.from_numpy(x),
            state=None if state is None else tuple(map(torch.from_numpy,
                                                       state)))
    close(got, want, FWD_REL)
    close(conv, w_conv, FWD_REL)
    close(h, w_h, FWD_REL)


@pytest.mark.parametrize("S", [37, 64])
def test_mamba_fwd_gradients_match_reference(block, S):
    rcfg, _, params, m = block
    rng = np.random.default_rng(10 + S)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    state = _state(rng)
    w_out = rng.normal(size=(2, S, 64)).astype(np.float32)
    w_h = rng.normal(size=(2, 128, 16)).astype(np.float32)

    def ref_loss(p, x):
        out, (_, h) = RM.mamba_fwd(p, x, rcfg, state=state)
        return jnp.sum(out * w_out) + jnp.sum(h * w_h)

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    out, (_, h) = mamba.mamba_fwd(m, xt,
                                  state=tuple(map(torch.from_numpy, state)))
    loss = (out * torch.from_numpy(w_out)).sum() + \
        (h * torch.from_numpy(w_h)).sum()
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [*m.parameters(), xt])
    assert set(names) == set(want_p)
    for name, g in zip(names, grads):
        close(g, want_p[name], GRAD_REL)
    close(grads[-1], want_x, GRAD_REL)
