"""K1 parity: the port's min-plus sweep against the reference.

The plain PyTorch version must equal the reference's numpy ``sweep_ref``
and ``_LayeredDP.dist_at`` exactly in float64 (every operation is +, max,
min or a compare), and fall within rtol 1e-4 of the Pallas kernel
``sweep_minplus`` in float32 (run in interpret mode on the CPU, as its own
tests run it).  ``sweep_cluster_plain``, the CUDA kernel's cluster
decomposition, must equal ``sweep_ref`` exactly too, for clusters that split
the nodes unevenly.  The wrapper's choice of route (``launch_plan``) is
pure Python and is checked here.  The CUDA kernel is held against the plain
version on the card; that case skips without a GPU.
"""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import build_graph, make_edge_network, vgg16_profile
from repro.core.shortest_path import _LayeredDP, _sweep
from repro.kernels import minplus as ref_minplus
from conftest import small_instance

from repro_torch.kernels import _build
from repro_torch.kernels.minplus import kernel as k1
from repro_torch.kernels.minplus import sweep_minplus, sweep_plain
from repro_torch.kernels.minplus.ref import (cluster_ranges,
                                             sweep_cluster_plain)

SEEDS = [0, 1, 5]
MODES = ["sum", "max"]
#: cluster sizes for the decomposition: one block, and splits of 7 (the
#: quickstart's nodes) and 4 (the small instance's) that leave blocks
#: uneven or empty
CLUSTERS = [1, 2, 3, 16]
MAX_SHARED = 232_448


def _dp(seed, b=8, K=4):
    prof, net = small_instance(seed, num_layers=6, num_servers=3)
    return _LayeredDP(build_graph(prof, net, b), K)


def _np_args(dp):
    return (dp._Ccom[0], dp._Bcom[0], dp._Sseg[0], dp._Bseg[0],
            dp._src_cost[0], dp._src_beta[0])


def _torch_args(dp, dtype=torch.float64, device="cpu"):
    return [torch.tensor(a, dtype=dtype, device=device) for a in _np_args(dp)]


def _quickstart_dp(seed, b=4, K=7):
    """The quickstart's graph (VGG-16, 6 servers + 4 clients) on the
    network drawn from ``seed``."""
    net = make_edge_network(num_servers=6, num_clients=4, seed=seed,
                            kappa=1 / 32.0)
    return _LayeredDP(build_graph(vgg16_profile(work_units="bytes"), net, b),
                      K)


def _window(dp):
    """About 20 of the graph's thresholds, one under every beta (nothing
    reachable), the neighbours of beta* and infinity."""
    betas = dp.all_betas()
    beta_star = float(sweep_plain(*_torch_args(dp), dp.K,
                                  torch.tensor([math.inf]), mode="max")[0])
    near = betas[np.searchsorted(betas, beta_star) - 1:][:2]
    return np.concatenate([[betas[0] - 1.0], betas[::max(1, len(betas) // 16)],
                           near, [math.inf]])


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


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph", ["quickstart", "small"])
def test_cluster_decomposition_equals_reference_exactly(graph, mode, seed, C):
    """Per-block destination ranges, a dist all-gather per layer, the
    cluster-wide early exit and a final min give the reference's values bit
    for bit in float64."""
    dp = _quickstart_dp(seed) if graph == "quickstart" else _dp(seed)
    ts = _window(dp)
    got = sweep_cluster_plain(*_torch_args(dp), dp.K, torch.from_numpy(ts),
                              mode=mode, C=C).numpy()
    want = ref_minplus.sweep_ref(*_np_args(dp), dp.K, ts, mode=mode)
    assert np.array_equal(got, want)
    assert np.isinf(got[0]) and np.isfinite(got).any()


@pytest.mark.parametrize("N,C", [(7, 1), (7, 2), (7, 3), (7, 16), (49, 13),
                                 (49, 16), (4, 3)])
def test_cluster_ranges_split_every_node_once(N, C):
    ranges = cluster_ranges(N, C)
    assert [m for m0, m1 in ranges for m in range(m0, m1)] == list(range(N))
    sizes = [m1 - m0 for m0, m1 in ranges]
    assert max(sizes) == -(-N // C) and max(sizes) - min(sizes) <= 1


#: (S, N, I + 1, bytes per value, route, the plan's cluster or tile)
ROUTES = {
    "quickstart window f64": (1, 7, 17, 8, "cluster", 1),
    "quickstart window f32": (1, 7, 17, 4, "cluster", 1),
    "fleet window f64": (1, 49, 31, 8, "cluster", None),
    "fleet window f32": (1, 49, 31, 4, "cluster", None),
    "quickstart all-thresholds": (342, 7, 17, 8, "tiled", 4),
    "fleet all-thresholds": (1013, 49, 31, 8, "tiled", 8),
    "past the fleet": (1, 97, 31, 8, "tiled", 1),
    "past the fleet, 256 thresholds": (256, 97, 31, 8, "tiled", 2),
    "65 nodes": (4, 65, 31, 8, "cluster", 16),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_launch_plan_picks_the_route_by_shape(name):
    S, N, I1, esize, route, size = ROUTES[name]
    plan = k1.launch_plan(S, N, I1, esize)
    assert plan.route == route
    if route == "cluster":
        C = plan.cluster
        assert plan.tile == 0 and 1 <= C <= min(N, 16) and S * C <= 132
        assert 0 < k1.cluster_smem_bytes(N, I1, C, esize) <= MAX_SHARED
        assert I1 * -(-N // C) * k1.PARTS <= k1.MAX_THREADS
        assert k1.cluster_fits(N, I1, C, esize)
        if size is not None:
            assert C == size
        # no smaller cluster has a slice within the target
        assert all(k1.slice_bytes(N, I1, c, esize) > k1.SLICE_BYTES
                   for c in range(1, C)) or C == size
    else:
        assert plan.cluster == 0 and plan.tile == size
        assert k1.tiled_smem_bytes(N, I1, size, esize) \
            == 2 * N * I1 * size * esize <= MAX_SHARED


def test_launch_plan_fleet_cluster_fits_and_beats_smaller_slices():
    plan = k1.launch_plan(1, 49, 31, 8)
    assert 1 < plan.cluster <= 16
    assert k1.cluster_smem_bytes(49, 31, plan.cluster, 8) <= MAX_SHARED
    assert k1.slice_bytes(49, 31, plan.cluster, 8) <= k1.SLICE_BYTES
    assert k1.slice_bytes(49, 31, plan.cluster - 1, 8) > k1.SLICE_BYTES
    # as many thresholds as 132 SMs hold clusters of that size, then tiles
    assert k1.launch_plan(132 // plan.cluster, 49, 31, 8).route == "cluster"
    assert k1.launch_plan(132 // 7 + 1, 49, 31, 8).route == "tiled"


@pytest.mark.parametrize("esize", [8, 4])
def test_launch_plan_takes_every_graph_the_parent_kernel_took(esize):
    """The parent design held dist and A of one threshold in one block:
    every such graph still gets a route, at every S; a larger one raises."""
    for N in (1, 2, 7, 49, 97, 181):
        for I1 in (1, 2, 17, 31, 64, 81):
            parent_ok = 2 * N * I1 * esize <= MAX_SHARED
            for S in (1, 5, 342, 5000):
                if parent_ok:
                    plan = k1.launch_plan(S, N, I1, esize)
                    assert (k1.cluster_fits(N, I1, plan.cluster, esize)
                            if plan.route == "cluster"
                            else k1.tile_fits(N, I1, plan.tile, esize))
                else:
                    with pytest.raises(ValueError, match="too large"):
                        k1.launch_plan(S, N, I1, esize)


# -- the graph axis: many graphs in one call ----------------------------------

def _stacked(seeds, b=8, K=4):
    """One graph per seed (the small instance's), stacked on a leading
    axis, as numpy arrays and as the reference DPs."""
    dps = [_dp(seed, b=b, K=K) for seed in seeds]
    return dps, [np.stack(parts) for parts in zip(*map(_np_args, dps))]


def _graph_window(dps, sizes):
    """``sizes[g]`` thresholds of graph g, interleaved across the graphs:
    (graph index per threshold, thresholds)."""
    graph, ts = [], []
    for g, (dp, n) in enumerate(zip(dps, sizes)):
        w = _window(dp)
        graph += [g] * n
        ts += list(w[np.linspace(0, len(w) - 1, n).round().astype(int)])
    order = np.random.default_rng(0).permutation(len(ts))
    return np.asarray(graph)[order], np.asarray(ts)[order]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sizes", [(1, 1, 1), (5, 1, 9), (8, 3, 16)])
def test_plain_graph_axis_equals_reference_gathered_sweep(sizes, mode):
    """Threshold s on graph graph[s] equals the reference's ``_sweep`` over
    the gathered leading slice axis (its ``Ccom[sel]``), bit for bit in
    float64, for groups of uneven sizes in no order."""
    dps, stacked = _stacked([0, 1, 5])
    graph, ts = _graph_window(dps, sizes)
    want = _sweep(*(a[graph] for a in stacked), dps[0].K, ts,
                  mode=mode).best_val
    args = [torch.from_numpy(a) for a in stacked]
    got = sweep_plain(*args, dps[0].K, torch.from_numpy(ts), mode=mode,
                      graph=torch.from_numpy(graph))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(sweep_minplus(*args, dps[0].K, torch.from_numpy(ts),
                                     mode=mode, graph=graph.tolist()), got)
    for C in (1, 3):
        assert np.array_equal(sweep_cluster_plain(
            *args, dps[0].K, torch.from_numpy(ts), mode=mode, C=C,
            graph=graph).numpy(), want)


@pytest.mark.parametrize("T", [1, 2, 4, 8])
@pytest.mark.parametrize("graph", [[0, 0, 0], [2, 0, 1, 0, 2, 2, 0],
                                   list(range(5)), [3] * 17, []])
def test_tile_slots_pad_each_graph_to_whole_tiles(graph, T):
    """Every threshold gets its own slot; every tile holds one graph; a
    graph's tiles hold its thresholds in order; padding only ends a
    graph's last tile."""
    slots, slot_graph = k1.tile_slots(graph, T)
    assert len(slot_graph) % T == 0
    assert sorted(slots) == sorted(set(slots))
    assert [slot_graph[q] for q in slots] == graph
    for t0 in range(0, len(slot_graph), T):
        assert len(set(slot_graph[t0:t0 + T])) == 1
    counts = {g: graph.count(g) for g in set(graph)}
    assert len(slot_graph) == sum(-(-c // T) * T for c in counts.values())
    for g in counts:
        mine = [slots[s] for s, h in enumerate(graph) if h == g]
        assert mine == sorted(mine) and mine[-1] - mine[0] == len(mine) - 1


def test_launch_plan_counts_padded_tiles_on_stacked_graphs():
    """With stacked graphs a tile counts the padded slots: 128 graphs of 9
    thresholds fill 132 SMs at no T (sum(ceil(9 / T)) > 132 for every T
    up to 8), so T = 8 is taken; 8 graphs of 60 take T = 4 (120 tiles),
    as 480 unstacked thresholds do; 300 graphs of one threshold take T = 8
    where 300 unstacked thresholds take 4; a cluster needs no padding and
    keeps its rule."""
    assert k1.launch_plan(128 * 9, 7, 17, 8, 132, (9,) * 128).tile == 8
    assert k1.launch_plan(480, 49, 31, 8, 132, (60,) * 8).tile == 4
    assert k1.launch_plan(480, 49, 31, 8, 132).tile == 4
    # 300 graphs of one threshold each: 300 tiles at every T
    assert k1.launch_plan(300, 7, 17, 8, 132, (1,) * 300).tile == 8
    assert k1.launch_plan(300, 7, 17, 8, 132).tile == 4
    assert k1.launch_plan(128, 7, 17, 8, 132, (1,) * 128) == \
        k1.launch_plan(128, 7, 17, 8, 132)
    assert k1.launch_plan(8, 49, 31, 8, 132, (1,) * 8).route == "cluster"


def test_graph_axis_argument_checks():
    dps, stacked = _stacked([0, 1])
    args = [torch.from_numpy(a) for a in stacked]
    ts = torch.tensor([1.0, 2.0, math.inf], dtype=torch.float64)
    with pytest.raises(ValueError, match="entries"):
        k1.graph_index([0, 1], 3, 2)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        k1.graph_index([0, 2, 1], 3, 2)
    assert k1.graph_index(torch.tensor([1, 0, 1]), 3, 2).tolist() == [1, 0, 1]
    got = sweep_minplus(*args, dps[0].K, ts, graph=[1, 0, 1])
    want = torch.stack([sweep_plain(*[a[g] for a in args], dps[0].K,
                                    ts[s:s + 1])[0]
                        for s, g in enumerate([1, 0, 1])])
    assert torch.equal(got, want)
