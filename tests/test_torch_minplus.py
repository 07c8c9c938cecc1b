"""K1 parity: the port's min-plus sweep against the reference.

The plain PyTorch version must equal the reference's numpy ``sweep_ref``
and ``_LayeredDP.dist_at`` exactly in float64 (every operation is +, max,
min or a compare), and fall within rtol 1e-4 of the Pallas kernel
``sweep_minplus`` in float32 (run in interpret mode on the CPU, as its own
tests run it).  The CUDA kernel is held against the plain version on the
card; that case skips without a GPU.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import build_graph
from repro.core.shortest_path import _LayeredDP
from repro.kernels import minplus as ref_minplus
from conftest import small_instance

from repro_torch.kernels import _build
from repro_torch.kernels.minplus import sweep_minplus, sweep_plain

SEEDS = [0, 1, 5]
MODES = ["sum", "max"]


def _dp(seed, b=8, K=4):
    prof, net = small_instance(seed, num_layers=6, num_servers=3)
    return _LayeredDP(build_graph(prof, net, b), K)


def _np_args(dp):
    return (dp._Ccom[0], dp._Bcom[0], dp._Sseg[0], dp._Bseg[0],
            dp._src_cost[0], dp._src_beta[0])


def _torch_args(dp, dtype=torch.float64, device="cpu"):
    return [torch.tensor(a, dtype=dtype, device=device) for a in _np_args(dp)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_f64_equals_reference_exactly(seed, mode):
    dp = _dp(seed)
    ts = dp.all_betas()
    got = sweep_plain(*_torch_args(dp), dp.K, torch.from_numpy(ts),
                      mode=mode).numpy()
    want = ref_minplus.sweep_ref(*_np_args(dp), dp.K, ts, mode=mode)
    assert np.array_equal(got, want)
    if mode == "sum":
        assert np.array_equal(got, dp.dist_at(ts))
    else:
        inf = sweep_plain(*_torch_args(dp), dp.K, torch.tensor([math.inf]),
                          mode="max")
        assert float(inf[0]) == dp.min_bottleneck()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_f32_matches_pallas_interpret(seed, mode):
    if not ref_minplus.pallas_available():      # pragma: no cover
        pytest.skip("pallas unavailable on this host")
    dp = _dp(seed)
    ts = dp.all_betas()[::3]
    got = sweep_plain(*_torch_args(dp, torch.float32), dp.K,
                      torch.from_numpy(ts).float(), mode=mode).double().numpy()
    want = ref_minplus.sweep_minplus(*_np_args(dp), dp.K, ts, mode=mode)
    finite = np.isfinite(want)
    assert (finite == np.isfinite(got)).all()
    assert np.allclose(got[finite], want[finite], rtol=1e-4)


def test_wrapper_takes_plain_version_on_cpu():
    dp = _dp(2)
    ts = torch.from_numpy(dp.all_betas())
    before = sweep_minplus.launches
    for mode in MODES:
        got = sweep_minplus(*_torch_args(dp), dp.K, ts, mode=mode)
        assert torch.equal(got, sweep_plain(*_torch_args(dp), dp.K, ts,
                                            mode=mode))
    assert sweep_minplus.launches == before      # no kernel ran
    with pytest.raises(ValueError, match="mode"):
        sweep_minplus(*_torch_args(dp), dp.K, ts, mode="min")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    """A library is built once per source content and rebuilt when the
    source changes (a stand-in compiler records its calls)."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho x >> "%s"\nwhile [ "$1" != "-o" ]; '
                    'do shift; done\necho lib > "$2"\n' % calls)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = _build.build_library("k", [src])
    assert first.exists() and _build.build_library("k", [src]) == first
    src.write_text("// v2\n")
    second = _build.build_library("k", [src])
    assert second != first and second.exists()
    assert calls.read_text().count("x") == 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_on_gpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the CUDA kernel runs only on the card")
    dp = _dp(1)
    ts = torch.from_numpy(dp.all_betas()).cuda()
    args = _torch_args(dp, device="cuda")
    before = sweep_minplus.launches
    got = sweep_minplus(*args, dp.K, ts, mode=mode)
    torch.cuda.synchronize()
    assert sweep_minplus.launches == before + 1
    assert torch.equal(got, sweep_plain(*args, dp.K, ts, mode=mode))
    args32 = [a.float() for a in args]
    got32 = sweep_minplus(*args32, dp.K, ts.float(), mode=mode).double()
    want = got.cpu().numpy()
    finite = np.isfinite(want)
    assert (finite == np.isfinite(got32.cpu().numpy())).all()
    assert np.allclose(got32.cpu().numpy()[finite], want[finite], rtol=1e-4)
