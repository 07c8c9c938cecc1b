"""``launch/steps.py::make_train_step`` against the reference's: from the
same numpy-made weights, in float32 compute, the reduced ``qwen3-0.6b`` and
``rwkv6-1.6b`` take 3 AdamW steps of Q = 2 micro-batches on the same
``token_lm_batches`` data in both packages; each step's loss agrees within
rtol 1e-4 and both optimizers count 3 steps.  The helpers are
``tests/test_torch_lm_train.py``'s."""

import jax
import jax.numpy as jnp
import pytest

from repro.launch.steps import make_train_step as r_step
from repro.optim import get_optimizer as r_opt

from repro_torch.data import token_lm_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import get_optimizer as t_opt

from test_torch_lm_train import (LIBS, STEP_RTOL, _configs,  # noqa: F401
                                 _one_intra_op_thread, weights)


@pytest.mark.parametrize("arch", list(LIBS))
def test_three_adamw_steps_match_reference(arch, weights):  # noqa: F811
    rc, tc = _configs(arch)
    tree = weights(arch)
    ropt, topt = r_opt("adamw", lr=2e-3), t_opt("adamw", lr=2e-3)
    step_r = jax.jit(r_step(rc, ropt, 2))
    step_t = make_train_step(tc, topt, 2, device="cpu")
    params = jax.tree.map(jnp.asarray, tree)
    rstate = ropt.init(params)
    model = LIBS[arch].params_from_jax(tree, tc, "cpu")
    tstate = topt.init(dict(model.named_parameters()))
    data = token_lm_batches(batch=4, seq_len=16, vocab=rc.vocab, seed=1)
    for step in range(3):
        b = next(data)
        params, rstate, rloss = step_r(
            params, rstate, {k: jnp.asarray(v) for k, v in b.items()})
        model, tstate, tloss = step_t(model, tstate, b)
        assert float(tloss) == pytest.approx(float(rloss), rel=STEP_RTOL), \
            step
    assert int(tstate["t"]) == int(rstate["t"]) == 3
