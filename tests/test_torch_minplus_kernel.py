"""K1's CUDA kernel on both routes, held against the port's plain version.

This file imports no JAX, so it runs on the card as well as here:

    python -m pytest -q -m cuda tests/test_torch_minplus_kernel.py   # on a GPU

The wrapper picks the route from the shape (``launch_plan``): a cluster of
C blocks per threshold for a few thresholds (C = 1 at the quickstart's
graph, C > 8 at a 65-node graph in float64), tiles of T thresholds per
block for many.
On the card each route must equal ``sweep_plain`` bit for bit in float64
and fall within rtol 1e-4 (with the same finite entries) in float32, in
both modes, also for thresholds under which no state is reachable (the
early exit); those cases skip without a GPU.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import Planner, make_edge_network, vgg16_profile
from repro_torch.kernels.minplus import kernel as k1
from repro_torch.kernels.minplus import sweep_minplus, sweep_plain

MODES = ["sum", "max"]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("no GPU visible: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def quickstart_args():
    """The quickstart's K1 inputs (VGG-16, 6 servers + 4 clients, b = 4)
    and its candidate thresholds, on the CPU."""
    planner = Planner(vgg16_profile(work_units="bytes"),
                      make_edge_network(num_servers=6, num_clients=4, seed=1,
                                        kappa=1 / 32.0), device="cpu")
    dp = planner._dp(4, planner.default_K(None))
    return list(dp._kernel_args()), dp.all_betas()


def random_args(N, I1, K, seed=0, p_inf=0.3):
    """A random graph (a share ``p_inf`` of its edges missing) and its
    distinct betas, made with numpy."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(np.where(rng.random(shape) < p_inf, np.inf,
                                         rng.random(shape)))

    args = [draw(N, I1, N), draw(N, I1, N), draw(I1, N, I1),
            draw(I1, N, I1), draw(I1), draw(I1)]
    betas = torch.cat([args[1].flatten(), args[3].flatten(), args[5]])
    return args[:6] + [K], torch.unique(betas[torch.isfinite(betas)])


def thresholds(betas, S):
    """S thresholds: one under every beta (nothing reachable), infinity,
    and the rest spread over the betas."""
    spread = betas[torch.linspace(0, betas.numel() - 1, max(S - 2, 1))
                   .round().long()]
    lo = betas.min() - 1.0
    return torch.cat([lo[None], torch.tensor([math.inf], dtype=betas.dtype),
                      spread])[:S]


def case(name, dtype):
    """(args, ts, expected route, check of the plan) of a named case."""
    if name == "quickstart-cluster-1":
        args, betas = quickstart_args()
        return args, thresholds(betas, 4), "cluster", lambda p: p.cluster == 1
    if name == "cluster-over-8":
        # no cluster of fewer than 9 blocks holds 65 nodes in float64, nor
        # of fewer than 13 holds 97 nodes in float32
        N, I1 = (65, 31) if dtype == torch.float64 else (97, 31)
        args, betas = random_args(N, I1, 5)
        return args, thresholds(betas, 4), "cluster", lambda p: p.cluster > 8
    if name == "fleet-size-tiled":
        args, betas = random_args(49, 31, 6, seed=1)
        return args, thresholds(betas, 300), "tiled", lambda p: p.tile == 4
    raise KeyError(name)


CASES = ["quickstart-cluster-1", "cluster-over-8", "fleet-size-tiled"]


def on(dev, dtype, args):
    return [a.to(device=dev, dtype=dtype) if torch.is_tensor(a) else a
            for a in args]


def assert_matches(got, want, dtype):
    if dtype == torch.float64:
        assert torch.equal(got, want)
        return
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_kernel_routes_match_plain_on_gpu(gpu, name, mode, dtype):
    args, ts, route, plan_ok = case(name, dtype)
    N, I1 = args[0].shape[:2]
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    plan = k1.launch_plan(ts.numel(), N, I1, dtype.itemsize, sms)
    assert plan.route == route and plan_ok(plan), plan
    a = on(gpu, dtype, args)
    t = ts.to(device=gpu, dtype=dtype)
    got = sweep_minplus(*a, t, mode=mode)
    torch.cuda.synchronize()
    assert_matches(got, sweep_plain(*a, t, mode=mode), dtype)
    assert math.isinf(float(got[0]))          # nothing reachable under ts[0]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [6, 400])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_mixes_unreachable_and_reachable_thresholds_on_gpu(gpu, S,
                                                                  mode):
    """Thresholds under which nothing is reachable (early exit), or only
    states that die before the last layer, interleaved with reachable ones,
    on the cluster route (S = 6) and the tiled route (S = 400)."""
    args, betas = quickstart_args()
    beta_star = float(sweep_plain(*args, torch.tensor([math.inf],
                                                      dtype=torch.float64),
                                  mode="max")[0])
    under = betas[betas < beta_star]
    over = betas[betas >= beta_star]
    pick = lambda v, n: v[torch.linspace(0, v.numel() - 1, n).round().long()]
    ts = torch.stack([pick(under, S // 2), pick(over, S - S // 2)],
                     1).flatten()
    ts[::5] = -1.0                            # below every beta
    a = on(gpu, torch.float64, args)
    t = ts.to(gpu)
    got = sweep_minplus(*a, t, mode=mode)
    want = sweep_plain(*a, t, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.isinf(got[::5]).all() and torch.isfinite(got).any()


@pytest.mark.cuda
def test_launches_count_one_per_call_on_gpu(gpu):
    args, betas = quickstart_args()
    a = on(gpu, torch.float64, args)
    before = sweep_minplus.launches
    for S in (1, 3, 342):                    # cluster, cluster, tiled
        sweep_minplus(*a, thresholds(betas, S).to(gpu), mode="sum")
    sweep_minplus(*a, torch.tensor([math.inf], device=gpu), mode="max")
    torch.cuda.synchronize()
    assert sweep_minplus.launches == before + 4


def stacked_quickstart(bs=(1, 5, 9, 13, 17, 21, 25, 29)):
    """The quickstart's graphs at several micro-batch sizes stacked on a
    leading axis (as ``Planner.solve_many`` stacks them), with each
    graph's candidate thresholds, on the CPU."""
    planner = Planner(vgg16_profile(work_units="bytes"),
                      make_edge_network(num_servers=6, num_clients=4, seed=1,
                                        kappa=1 / 32.0), device="cpu")
    K = planner.default_K(None)
    parts, betas = [], []
    for b in bs:
        dp = planner._dp(b, K)
        parts.append([a.clone() for a in dp._kernel_args()[:6]])
        betas.append(dp.all_betas())
    return [torch.stack(p) for p in zip(*parts)] + [K], betas


def ragged_window(betas, sizes):
    """``sizes[g]`` thresholds of graph g (one under every beta first),
    in no order: (graph per threshold, thresholds)."""
    graph, ts = [], []
    for g, n in enumerate(sizes):
        graph += [g] * n
        ts.append(thresholds(betas[g], n))
    order = torch.randperm(len(graph), generator=torch.Generator()
                           .manual_seed(0))
    return torch.tensor(graph)[order], torch.cat(ts)[order]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("name", ["beta-star", "ragged-tiles", "fleet-size"])
def test_graph_axis_matches_plain_on_gpu(gpu, name, dtype, mode):
    """Many graphs in one launch: one threshold per graph at t = inf (the
    cluster route, as ``solve_many``'s phase B), groups of uneven sizes that
    do not fill whole tiles (the tiled route with padding, as phase C), and
    fleet-size graphs on both routes."""
    if name == "fleet-size":
        parts, betas = zip(*(random_args(49, 31, 6, seed=s)
                             for s in range(3)))
        args = [torch.stack(p) for p in zip(*(a[:6] for a in parts))] + [6]
        cases = [ragged_window(betas, (1, 1, 1)),
                 ragged_window(betas, (97, 3, 140))]
    else:
        args, betas = stacked_quickstart()
        if name == "beta-star":
            G = len(betas)
            cases = [(torch.arange(G), torch.full((G,), math.inf,
                                                  dtype=torch.float64))]
        else:
            cases = [ragged_window(betas, (37, 1, 9, 70, 2, 5, 44, 13))]
    a = on(gpu, dtype, args)
    for graph, ts in cases:
        t = ts.to(device=gpu, dtype=dtype)
        before = sweep_minplus.launches
        got = sweep_minplus(*a, t, mode=mode, graph=graph)
        torch.cuda.synchronize()
        assert sweep_minplus.launches == before + 1
        assert_matches(got, sweep_plain(*a, t, mode=mode, graph=graph), dtype)
        one = torch.cat([sweep_minplus(*[x[g] if torch.is_tensor(x) else x
                                         for x in a], t[s:s + 1], mode=mode)
                         for s, g in enumerate(graph.tolist())])
        assert_matches(got, one, dtype)
