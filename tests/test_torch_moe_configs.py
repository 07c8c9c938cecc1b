"""The MoE configs ``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b`` and
the VLM config ``internvl2-1b`` through the port's config substrate,
against the reference, full and reduced:

* every field of the port's copy has the reference's value, and each is
  registered under the reference's id;
* the full-width model has the reference's parameter count (the port's
  modules on the meta device against ``jax.eval_shape`` of the reference's
  initializer);
* ``configs/base.py::arch_profile`` (every array, every shape, both
  ``dtype_bytes``), ``count_params``, ``default_optimizer_name`` and
  ``supports_shape`` equal the reference's (``==``); qwen3-moe-235b's full
  count lands in the reference's 200e9-260e9 and its optimizer is
  Adafactor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import arch_profile as ref_profile
from repro.configs.base import count_params as ref_count
from repro.configs.base import supports_shape as ref_supports
from repro.launch import steps as ref_steps
from repro.models import get_model as ref_get_model

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (SHAPES, arch_profile, count_params,
                                      supports_shape)
from repro_torch.launch.steps import default_optimizer_name
from repro_torch.models import transformer
from repro_torch.models.registry import get_model

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "internvl2-1b")
PROFILE_FIELDS = ("fp_work", "bp_work", "act_bytes", "grad_bytes",
                  "param_bytes", "opt_bytes")


def test_configs_are_registered_under_the_reference_ids():
    assert set(ARCHS) <= set(ARCH_IDS)
    for arch in ARCHS:
        assert get_config(arch).name == arch
        assert get_model(get_config(arch, reduced=True), device="cpu")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch, reduced):
    port = get_config(arch, reduced=reduced)
    ref = ref_get_config(arch, reduced=reduced)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(got, torch.dtype):
            got, want = str(got)[6:], jnp.dtype(want).name
        assert got == want, f.name
    assert [port.is_moe_layer(i) for i in range(port.num_layers)] == \
        [ref.is_moe_layer(i) for i in range(ref.num_layers)]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    api = get_model(cfg, device="cpu")
    model = transformer.Transformer(cfg, device=torch.device("meta"))
    got = api.param_count(model)
    rcfg = ref_get_config(arch, reduced=reduced)
    shapes = jax.eval_shape(ref_get_model(rcfg).init, jax.random.PRNGKey(0))
    assert got == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_profile_count_policy_and_shapes_equal_the_reference(arch, reduced):
    port = get_config(arch, reduced=reduced)
    ref = ref_get_config(arch, reduced=reduced)
    assert count_params(port) == ref_count(ref)
    assert default_optimizer_name(port) == ref_steps.default_optimizer_name(
        ref)
    for shape in SHAPES:
        assert supports_shape(port, shape) == ref_supports(ref, shape)
        for dtype_bytes in (2, 4):
            got = arch_profile(port, shape, dtype_bytes)
            want = ref_profile(ref, shape, dtype_bytes)
            assert got.name == want.name
            for field in PROFILE_FIELDS:
                assert np.array_equal(getattr(got, field),
                                      getattr(want, field)), (shape, field)


def test_qwen3_moe_count_and_policy():
    cfg = get_config("qwen3-moe-235b-a22b")
    assert 200e9 < count_params(cfg) < 260e9
    assert default_optimizer_name(cfg) == "adafactor"
    assert default_optimizer_name(get_config("granite-moe-3b-a800m")) == \
        "adamw"
