"""The names ROADMAP Queue 1 item 7 lists as missing from the port, held to
the reference with ``==`` on the CPU: the multi-client data split, Table
II's constants, the MSP graph's edge accessors and statistics, the path
cost, and a VGG stage's initializer."""

import numpy as np
import pytest
import torch

import repro.configs.vgg16_sl as R_vgg16
import repro.core as R
from repro.core.shortest_path import path_cost as r_path_cost
from repro.data import synthetic as R_data
from repro.pipeline.stage import VGGStage as RVGGStage

import repro_torch.configs.vgg16_sl as T_vgg16
import repro_torch.core as T
from repro_torch.data import synthetic as T_data
from repro_torch.models import vgg as t_vgg
from repro_torch.pipeline import VGGStage as TVGGStage


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its many small CPU ops
    gain nothing from a thread pool, and parallel test workers each
    spinning a full pool oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quickstart(pkg):
    return (pkg.vgg16_profile(work_units="bytes"),
            pkg.make_edge_network(6, 4, seed=1, kappa=1 / 32.0))


@pytest.mark.parametrize("iid", [True, False])
def test_client_datasets_equal_reference(iid):
    want = R_data.client_datasets(4, samples=512, iid=iid, seed=3)
    got = T_data.client_datasets(4, samples=512, iid=iid, seed=3)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g.images, w.images)
        assert np.array_equal(g.labels, w.labels)
        for n in (5, 17):                       # the per-client draws
            dg, dw = g.draw(n), w.draw(n)
            assert np.array_equal(dg["images"], dw["images"])
            assert np.array_equal(dg["labels"], dw["labels"])


@pytest.mark.parametrize("alpha", [0.1, 0.5, 10.0])
def test_dirichlet_partition_equals_reference(alpha):
    labels = np.random.default_rng(0).integers(0, 10, 1000)
    want = R_data.dirichlet_partition(labels, 4, alpha, seed=7)
    got = T_data.dirichlet_partition(labels, 4, alpha, seed=7)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_vgg16_sl_constants_equal_reference():
    names = [n for n in dir(R_vgg16) if n.isupper()]
    assert names and names == [n for n in dir(T_vgg16) if n.isupper()]
    for n in names:
        assert getattr(T_vgg16, n) == getattr(R_vgg16, n), n
    rp, tp = R_vgg16.profile(), T_vgg16.profile()
    for field in ("fp_work", "bp_work", "act_bytes", "grad_bytes",
                  "param_bytes", "opt_bytes"):
        assert np.array_equal(getattr(rp, field), getattr(tp, field)), field


@pytest.mark.parametrize("b", [4, 16])
def test_graph_stats_edge_accessors_and_path_cost_equal_reference(b):
    (rp, rn), (tp, tn) = _quickstart(R), _quickstart(T)
    rg = R.build_graph(rp, rn, b)
    tg = T.build_graph(tp, tn, b, device="cpu")
    assert T.graph_stats(tg) == R.graph_stats(rg)
    N, I = rg.N, rg.I
    for n in range(N):
        for m in range(N):
            for i in range(I):
                for j in (i + 1, I):
                    assert tg.edge_cost(n, i, m, j) == rg.edge_cost(n, i, m,
                                                                    j)
                    assert tg.edge_beta(n, i, m, j) == rg.edge_beta(n, i, m,
                                                                    j)
    res = R.solve_msp(rp, rn, b, 512)
    for sol in (res.solution,
                R.SplitSolution(cuts=(3, 9, 16), placement=(0, 2, 5))):
        path = list(zip(sol.placement, sol.cuts))
        assert T.path_cost(tg, path) == r_path_cost(rg, path)


@pytest.fixture(scope="module")
def whole_vgg():
    return t_vgg.init_params(torch.Generator().manual_seed(4))


@pytest.mark.parametrize("lo,hi", [(0, 4), (13, 16)])
def test_vgg_stage_init_is_a_slice_of_the_whole_init(lo, hi, whole_vgg):
    """``jax.random`` cannot be reproduced: the port's stage init is held
    to slicing a whole-model init from the same generator, and its layers
    to the reference stage's shapes."""
    import jax
    got = TVGGStage.init(lo, hi, torch.Generator().manual_seed(4),
                         device="cpu")
    assert len(got) == hi - lo
    for a, b in zip(got, list(whole_vgg)[lo:hi]):
        assert a.index == b.index
        assert torch.equal(a.weight, b.weight)
        assert torch.equal(a.bias, b.bias)
    want = jax.eval_shape(
        lambda: RVGGStage(lo, hi).init(jax.random.PRNGKey(0)))
    mine = t_vgg.params_to_jax(got)
    assert [(p["w"].shape, p["b"].shape) for p in mine] == \
        [(tuple(p["w"].shape), tuple(p["b"].shape)) for p in want]
