"""The hybrid ``jamba-1.5-large-398b`` and the audio ``whisper-small``
through the port's config substrate and server, against the reference,
full and reduced:

* every field of the port's copy has the reference's value (and
  ``layer_kind`` / ``is_moe_layer`` give the same layer by layer), each
  registered under the reference's id, and every arch id of the reference
  builds in the port;
* the model has the reference's parameter count (the port's modules on the
  meta device against ``jax.eval_shape`` of the reference's initializer;
  jamba's one published period and its 2-layer cut too);
* ``configs/base.py::arch_profile`` (every array, every shape, both
  ``dtype_bytes``), ``count_params``, ``_mamba_layer_flops``,
  ``default_optimizer_name`` and ``supports_shape`` equal the reference's
  (``==``); jamba's full count lands in the reference's 360e9-430e9 and
  takes Adafactor;
* ``BatchedServer`` on the CPU generates exactly the reference server's
  tokens for the reduced jamba and whisper (three requests on two slots;
  whisper's prefill takes zero frames), from the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs.base import _mamba_layer_flops as ref_mamba_flops
from repro.configs.base import arch_profile as ref_profile
from repro.configs.base import count_params as ref_count
from repro.configs.base import supports_shape as ref_supports
from repro.launch import steps as ref_steps
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import get_model as ref_get_model
from test_torch_mamba import configs, fill_tree

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (SHAPES, _mamba_layer_flops,
                                      arch_profile, count_params,
                                      supports_shape)
from repro_torch.launch import serve
from repro_torch.launch.steps import default_optimizer_name
from repro_torch.models import jamba, whisper
from repro_torch.models.registry import get_model

ARCHS = ("jamba-1.5-large-398b", "whisper-small")
PROFILE_FIELDS = ("fp_work", "bp_work", "act_bytes", "grad_bytes",
                  "param_bytes", "opt_bytes")
MODELS = {"hybrid": (jamba.Jamba, jamba.params_from_jax),
          "audio": (whisper.Whisper, whisper.params_from_jax)}
#: jamba's published period and the 2-layer cut served on one card
JAMBA_CUTS = {"one period": {"num_layers": 8},
              "two-layer period": {"num_layers": 2, "attn_every": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_reference_arch_is_registered():
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)
    for arch in ARCHS:
        assert get_config(arch).name == arch


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
    assert [(port.layer_kind(i), port.is_moe_layer(i))
            for i in range(port.num_layers)] == \
        [(ref.layer_kind(i), ref.is_moe_layer(i))
         for i in range(ref.num_layers)]


def _count(cls, cfg):
    return sum(p.numel() for p in cls(cfg, device=torch.device("meta"))
               .parameters())


def _ref_count(cfg):
    shapes = jax.eval_shape(ref_get_model(cfg).init, jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    cls = MODELS[cfg.family][0]
    assert _count(cls, cfg) == _ref_count(ref_get_config(arch, reduced))


@pytest.mark.parametrize("cut", JAMBA_CUTS)
def test_jamba_cut_parameter_count(cut):
    """45,238,345,728 parameters in one published period, 11,912,896,512
    in the 2-layer period (``PERF.md`` §4)."""
    arch = "jamba-1.5-large-398b"
    port = dataclasses.replace(get_config(arch), **JAMBA_CUTS[cut])
    ref = dataclasses.replace(ref_get_config(arch), **JAMBA_CUTS[cut])
    n = _count(jamba.Jamba, port)
    assert n == _ref_count(ref)
    assert n == {"one period": 45_238_345_728,
                 "two-layer period": 11_912_896_512}[cut]


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
        seq = SHAPES[shape].seq_len
        assert _mamba_layer_flops(port, seq) == ref_mamba_flops(ref, seq)
        for dtype_bytes in (2, 4):
            got = arch_profile(port, shape, dtype_bytes)
            want = ref_profile(ref, shape, dtype_bytes)
            assert got.name == want.name
            for field in PROFILE_FIELDS:
                assert np.array_equal(getattr(got, field),
                                      getattr(want, field)), (shape, field)


def test_jamba_count_and_policy():
    cfg = get_config("jamba-1.5-large-398b")
    assert 360e9 < count_params(cfg) < 430e9
    assert default_optimizer_name(cfg) == "adafactor"
    assert default_optimizer_name(get_config("whisper-small")) == "adamw"


def _requests(make, vocab):
    rng = np.random.default_rng(0)
    return [make(rid, rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new=6) for rid, n in enumerate((8, 5, 8))]


def _summary(stats):
    return (stats["ticks"], stats["tokens"],
            [(r.rid, tuple(r.generated), r.done) for r in stats["completed"]])


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generates_the_reference_tokens(arch):
    rcfg, pcfg = configs(arch)
    tree = fill_tree(jax.eval_shape(ref_get_model(rcfg).init,
                                    jax.random.PRNGKey(0)), seed=11)
    ref = RefServer(arch, reduced=True, batch=2, cache_len=24)
    api = ref_get_model(rcfg)
    ref.cfg = rcfg
    ref.api = dataclasses.replace(api, prefill=jax.jit(api.prefill,
                                                       static_argnums=2))
    ref.decode = jax.jit(api.decode)
    ref.params = jax.tree.map(jnp.asarray, tree)
    for req in _requests(RefRequest, rcfg.vocab):
        ref.submit(req)
    want = ref.run()

    model = MODELS[pcfg.family][1](tree, pcfg, "cpu")
    port = serve.BatchedServer(arch, reduced=True, batch=2, cache_len=24,
                               device="cpu", params=model, config=pcfg)
    assert port.cfg is pcfg
    batch = port.prefill_batch(np.arange(5))
    if pcfg.family == "audio":
        assert batch["frames"].shape == (1, pcfg.encoder_frames,
                                         pcfg.d_model)
        assert batch["frames"].dtype == pcfg.compute_dtype
        assert float(batch["frames"].abs().max()) == 0.0
    else:
        assert set(batch) == {"tokens"}
    for req in _requests(serve.Request, pcfg.vocab):
        port.submit(req)
    got = port.run()
    assert _summary(got) == _summary(want)
    assert len(got["completed"]) == 3
    assert all(len(r.generated) == 6 for r in got["completed"])
