"""The port's ``BatchedServer`` against the reference's, from the same
weights: the same requests must come back with exactly the same tokens.

Both servers run the reduced ``rwkv6-1.6b`` config in float32 compute (in
bfloat16 the two frameworks round at different points, so a greedy
``argmax`` may pick another token on a near tie).  The test swaps the
config, model API and weights into each server after construction; the
reference's prefill and decode run under ``jax.jit``.  Three requests on
two slots exercise admission, continuous batching and retirement; one
prompt has an odd length (11 tokens: the scan takes chunk 11).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import get_model as ref_get_model
from test_torch_rwkv6 import reference_tree
from test_torch_transformer import reference_tree as transformer_tree

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import rwkv6, transformer
from repro_torch.models.registry import get_model

PROMPT_LENS = (16, 11, 16)
MAX_NEW = 6


def requests(make, vocab, prompt_lens=PROMPT_LENS):
    rng = np.random.default_rng(0)
    return [make(rid, rng.integers(0, vocab, size=n).astype(np.int32),
                 max_new=MAX_NEW) for rid, n in enumerate(prompt_lens)]


def summary(stats):
    return (stats["ticks"], stats["tokens"],
            [(r.rid, tuple(r.generated), r.done) for r in stats["completed"]])


@pytest.fixture(scope="module")
def served():
    rcfg = dataclasses.replace(ref_get_config("rwkv6-1.6b", reduced=True),
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                               compute_dtype=torch.float32)
    tree = reference_tree(rcfg, seed=2)

    ref = RefServer("rwkv6-1.6b", reduced=True, batch=2, cache_len=64)
    api = ref_get_model(rcfg)
    ref.cfg = rcfg
    ref.api = dataclasses.replace(api,
                                  prefill=jax.jit(api.prefill,
                                                  static_argnums=2))
    ref.decode = jax.jit(api.decode)
    ref.params = jax.tree.map(jnp.asarray, tree)
    for req in requests(RefRequest, rcfg.vocab):
        ref.submit(req)
    want = ref.run()

    port = serve.BatchedServer("rwkv6-1.6b", reduced=True, batch=2,
                               cache_len=64, device="cpu",
                               params=rwkv6.params_from_jax(tree, pcfg,
                                                            "cpu"))
    port.cfg = pcfg
    port.api = get_model(pcfg, device="cpu")
    port.decode = port.api.decode
    for req in requests(serve.Request, pcfg.vocab):
        port.submit(req)
    return want, port.run()


def qwen3_served(prompt_lens, cache_len):
    """The same requests through both servers on the reduced ``qwen3-0.6b``
    in float32, from the same weights; returns (reference stats, port
    stats)."""
    rcfg = dataclasses.replace(ref_get_config("qwen3-0.6b", reduced=True),
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                               compute_dtype=torch.float32)
    tree = transformer_tree(rcfg, seed=2)

    ref = RefServer("qwen3-0.6b", reduced=True, batch=2, cache_len=cache_len)
    api = ref_get_model(rcfg)
    ref.cfg = rcfg
    ref.api = dataclasses.replace(api,
                                  prefill=jax.jit(api.prefill,
                                                  static_argnums=2))
    ref.decode = jax.jit(api.decode)
    ref.params = jax.tree.map(jnp.asarray, tree)
    for req in requests(RefRequest, rcfg.vocab, prompt_lens):
        ref.submit(req)
    want = ref.run()

    port = serve.BatchedServer(
        "qwen3-0.6b", reduced=True, batch=2, cache_len=cache_len,
        device="cpu", params=transformer.params_from_jax(tree, pcfg, "cpu"))
    port.cfg = pcfg
    port.api = get_model(pcfg, device="cpu")
    port.decode = port.api.decode
    for req in requests(serve.Request, pcfg.vocab, prompt_lens):
        port.submit(req)
    return want, port.run()


def test_qwen3_server_generates_the_reference_tokens():
    """The KV caches live per slot, the prefill attention goes through K2's
    wrapper (its plain version here)."""
    want, got = qwen3_served(PROMPT_LENS, 32)
    assert summary(got) == summary(want)
    assert len(got["completed"]) == len(PROMPT_LENS)
    assert all(len(r.generated) == MAX_NEW for r in got["completed"])


def test_qwen3_server_with_a_cache_len_prompt_matches_reference():
    """A prompt of exactly ``cache_len`` tokens: its one decode step runs at
    ``pos == cache_len``, where both write this token's k and v at the last
    cache entry, then the slot retires."""
    want, got = qwen3_served((32, 32, 32, 11), 32)
    assert summary(got) == summary(want)
    full = [r for r in got["completed"] if len(r.prompt) == 32]
    assert len(full) == 3
    assert all(len(r.generated) == 2 and r.done for r in full)


def test_server_generates_the_reference_tokens(served):
    want, got = served
    assert summary(got) == summary(want)
    assert len(got["completed"]) == len(PROMPT_LENS)
    assert all(len(r.generated) == MAX_NEW for r in got["completed"])


def test_server_stats_have_the_reference_keys(served):
    want, got = served
    assert set(got) == set(want)
    assert got["tok_per_s"] > 0 and got["seconds"] > 0


def test_server_retires_at_cache_end():
    """A slot retires when its position reaches cache_len - 1, as in the
    reference, even before max_new tokens."""
    srv = serve.BatchedServer("rwkv6-1.6b", reduced=True, batch=1,
                              cache_len=12, device="cpu", seed=1)
    srv.submit(serve.Request(0, np.arange(8, dtype=np.int32), max_new=50))
    stats = srv.run()
    (req,) = stats["completed"]
    assert req.done and len(req.generated) == 1 + (12 - 1 - 8)
    assert stats["tokens"] == 3


def test_server_is_seeded():
    def tokens(seed):
        srv = serve.BatchedServer("rwkv6-1.6b", reduced=True, batch=2,
                                  cache_len=32, device="cpu", seed=seed)
        for req in requests(serve.Request, srv.cfg.vocab):
            srv.submit(req)
        return summary(srv.run())

    assert tokens(3) == tokens(3)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rwkv6-1.6b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.BatchedServer("rwkv6-1.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    api = get_model(cfg, device="cpu")
    assert api.device == torch.device("cpu")
    model = api.init(torch.Generator().manual_seed(0))
    assert api.param_count(model) == sum(p.numel()
                                         for p in model.parameters())
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_profile_serve_reports_both_windows():
    from repro_torch.launch.profile_serve import profile_serve
    out = profile_serve(prompt_len=8, steps=2, device="cpu")
    assert out["arch"] == "rwkv6-1.6b-reduced" and out["card"] is None
    for phase in ("prefill", "decode"):
        assert out[phase]["wall_ms"] > 0
        assert out[phase]["device_busy_ms"] is None       # no card here
    assert out["decode"]["tokens_per_s"] > 0


def test_main_serves_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "6",
                "--gen", "3"])
    assert "served 2 requests" in capsys.readouterr().out
