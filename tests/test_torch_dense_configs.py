"""The dense configs ``llama3-8b``, ``qwen1.5-4b`` and ``command-r-35b``
through the port, against the reference.

* Every field of the port's copy of each config (full and reduced) has the
  reference's value; the full-width model has the reference's parameter
  count (the port's modules on the meta device against ``jax.eval_shape``
  of the reference's initializer).
* ``configs/base.py::arch_profile`` (every array, every shape, both
  ``dtype_bytes`` the trainer and planner pass) and ``count_params`` equal
  the reference's (``==``), full and reduced: the planner's profile, which
  counts the head whether tied or not and no bias.
* The reduced configs end to end in float32, from the same numpy-made
  weights (``tests/test_torch_dense_options.py``'s helpers): the
  ``params_from_jax`` / ``params_to_jax`` round trip, a 72-token prefill
  and 8 decode steps (logits and KV cache within atol = rtol = 1e-4), the
  loss (rtol 1e-5) and every gradient (1e-4 of its largest magnitude).
  ``command-r-35b``'s reduced head size is 8 (K2 and K2' take it
  zero-padded to 16 on the card; here the plain versions run).
* One ``BatchedServer`` run per config generates exactly the reference
  server's tokens (float32; three requests on two slots), as
  ``tests/test_torch_serve.py`` does for ``qwen3-0.6b``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import arch_profile as ref_profile
from repro.configs.base import count_params as ref_count
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import get_model as ref_get_model
from repro.models import transformer as R
from test_torch_dense_options import (check_serving, check_training,
                                      configs, reference_tree)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, arch_profile, count_params
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.registry import get_model

ARCHS = ("llama3-8b", "qwen1.5-4b", "command-r-35b")
PROFILE_FIELDS = ("fp_work", "bp_work", "act_bytes", "grad_bytes",
                  "param_bytes", "opt_bytes")
#: the real parameter count at full width (embedding, layers, final norm,
#: lm_head when untied), as the reference's initializer makes them
FULL_PARAMS = {"llama3-8b": 8_030_261_248, "qwen1.5-4b": 3_950_369_280,
               "command-r-35b": 30_283_538_432}


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
            cache[arch] = reference_tree(configs(arch)[0], seed=1)
        return cache[arch]
    return get


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
    assert (port.head_dim, port.q_per_kv) == (ref.head_dim, ref.q_per_kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_count(arch):
    cfg = get_config(arch)
    model = transformer.Transformer(cfg, device=torch.device("meta"))
    got = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda k: R.init_params(k, ref_get_config(arch)),
                            jax.random.PRNGKey(0))
    assert got == sum(int(np.prod(a.shape))
                      for a in jax.tree.leaves(shapes)) == FULL_PARAMS[arch]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_profile_and_count_params_equal_the_reference(arch, reduced):
    port = get_config(arch, reduced=reduced)
    ref = ref_get_config(arch, reduced=reduced)
    assert count_params(port) == ref_count(ref)
    assert tuple(SHAPES) == tuple(REF_SHAPES)
    for shape in SHAPES:
        for dtype_bytes in (2, 4):
            got = arch_profile(port, shape, dtype_bytes)
            want = ref_profile(ref, shape, dtype_bytes)
            assert got.name == want.name
            for field in PROFILE_FIELDS:
                assert np.array_equal(getattr(got, field),
                                      getattr(want, field)), (shape, field)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, trees):
    _, pcfg = configs(arch)
    tree = trees(arch)
    model = transformer.params_from_jax(tree, pcfg, "cpu")
    back = transformer.params_to_jax(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, a in flat:
        assert np.array_equal(back_flat[path], a), path


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_serving_matches_reference(arch, trees):
    rcfg, pcfg = configs(arch)
    check_serving(rcfg, pcfg, trees(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_and_gradients_match_reference(arch, trees):
    rcfg, pcfg = configs(arch)
    names = check_training(rcfg, pcfg, trees(arch), S=48)
    assert ("lm_head" in names) == (not pcfg.tie_embeddings)
    assert ({"layers/bq", "layers/bk", "layers/bv"} <= set(names)) == \
        pcfg.qkv_bias


def _requests(make, vocab):
    rng = np.random.default_rng(0)
    return [make(rid, rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new=6) for rid, n in enumerate((16, 11, 16))]


def _summary(stats):
    return (stats["ticks"], stats["tokens"],
            [(r.rid, tuple(r.generated), r.done) for r in stats["completed"]])


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generates_the_reference_tokens(arch, trees):
    rcfg, pcfg = configs(arch)
    tree = trees(arch)
    ref = RefServer(arch, reduced=True, batch=2, cache_len=32)
    api = ref_get_model(rcfg)
    ref.cfg = rcfg
    ref.api = dataclasses.replace(api, prefill=jax.jit(api.prefill,
                                                       static_argnums=2))
    ref.decode = jax.jit(api.decode)
    ref.params = jax.tree.map(jnp.asarray, tree)
    for req in _requests(RefRequest, rcfg.vocab):
        ref.submit(req)
    want = ref.run()

    port = serve.BatchedServer(
        arch, reduced=True, batch=2, cache_len=32, device="cpu",
        params=transformer.params_from_jax(tree, pcfg, "cpu"))
    port.cfg = pcfg
    port.api = get_model(pcfg, device="cpu")
    port.decode = port.api.decode
    for req in _requests(serve.Request, pcfg.vocab):
        port.submit(req)
    got = port.run()
    assert _summary(got) == _summary(want)
    assert len(got["completed"]) == 3
    assert all(len(r.generated) == 6 for r in got["completed"])
