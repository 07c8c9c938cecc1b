"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``): from the same numpy-made parameters, both take three
updates with the same numpy gradients, from zero state; every parameter
and every state tensor after each update within rtol 1e-6 (a few float32
ulps: the two frameworks round the same formulas in their own order).

The tree holds a 2-D, a 3-D and a 1-D leaf, so Adafactor's factored (row
and column) and unfactored second moments both run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as T
from repro_torch.utils import (global_norm, tree_add, tree_bytes,
                               tree_leaves, tree_map, tree_scale)

RTOL = 1e-6
SHAPES = {"w": (6, 5), "stack": (2, 4, 3), "b": (5,)}
CASES = {"sgd": {"lr": 0.05}, "momentum": {"lr": 0.05, "beta": 0.9},
         "adamw": {"lr": 1e-2, "weight_decay": 0.1},
         "adafactor": {"lr": 1e-2}}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want, what):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(
        np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_three_updates_match_reference(name):
    p0 = _arrays(0)
    grads = [_arrays(10 + s, scale=0.3 + s) for s in range(3)]
    ropt = R.get_optimizer(name, **CASES[name])
    topt = T.get_optimizer(name, **CASES[name])
    assert topt.state_bytes_per_param == ropt.state_bytes_per_param
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = ropt.init(rp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    leaves = list(tp.values())
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        rp, rs = ropt.update(rp, {k: jnp.asarray(v) for k, v in g.items()},
                             rs)
        tp, ts = topt.update(tp, {k: torch.tensor(v) for k, v in g.items()},
                             ts)
        # the update is in place: the caller's tensors hold the step
        assert all(a is b for a, b in zip(tp.values(), leaves))
        for k in SHAPES:
            _close(tp[k], rp[k], f"{name} step {step} param {k}")
        rleaves = jax.tree.leaves(rs)
        tleaves = tree_leaves(ts)
        assert len(rleaves) == len(tleaves)
        for i, (a, b) in enumerate(zip(tleaves, rleaves)):
            _close(a, b, f"{name} step {step} state leaf {i}")


def test_optimizer_state_bytes_per_param_equals_reference():
    for name in CASES:
        assert T.optimizer_state_bytes_per_param(name) == \
            R.optimizer_state_bytes_per_param(name)


def test_adamw_state_is_a_dict_of_tensors_in_place_on_a_list():
    """A list of leaves (the trainer's ``list(model.parameters())``) works
    as well as a dict, and the state checkpoints as tensors."""
    ps = [torch.ones(3, 2), torch.zeros(4)]
    opt = T.adamw(lr=0.1)
    st = opt.init(ps)
    assert set(st) == {"m", "v", "t"} and st["t"].dtype == torch.int32
    out, st = opt.update(ps, [torch.ones(3, 2), torch.ones(4)], st)
    assert out is ps and int(st["t"]) == 1
    assert float(ps[1][0]) == pytest.approx(-0.1, rel=1e-5)


def test_treemath_matches_reference():
    from repro.utils import treemath as RT
    a, b = _arrays(1), _arrays(2)
    ta = {k: torch.tensor(v) for k, v in a.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    for k, v in tree_add(ta, tb).items():
        _close(v, RT.tree_add(ja, jb)[k], "tree_add")
    for k, v in tree_scale(ta, 0.3).items():
        _close(v, RT.tree_scale(ja, 0.3)[k], "tree_scale")
    assert tree_bytes(ta) == RT.tree_bytes(ja)
    _close(global_norm(ta), RT.global_norm(ja), "global_norm")
    assert tree_map(lambda x: x.shape, [ta["w"], (ta["b"],)]) == \
        [ta["w"].shape, (ta["b"].shape,)]
