"""The port's batched device planner against the reference's jax backend.

The port of ``tests/test_planner_jax.py``: ``backend="device"`` (the
counterpart of the reference's ``backend="jax"``) on the same numpy-seeded
instances, ``device="cpu"`` (K1's plain version).  In float64 the port's
``solve``, ``solve_many`` and ``dist_at_device`` equal the reference's
numpy backend and its jax backend under x64 bit for bit; in float32 they
meet the reference's float32 contract: feasibility equal, the
float64-repriced objective within rtol 1e-4 (``parity_tolerance``), ``b``
equal.  Every test that flips jax's x64 flag restores it (``_x64``).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.core as R
from repro.core.shortest_path import _LayeredDP as R_LayeredDP
from conftest import same_msp_result

import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import planner_device as PD
from repro_torch.core.shortest_path import _walk_parents, stack_column

DTYPES = [torch.float64, torch.float32]


class _x64:
    """Temporarily force jax's x64 flag; restores the prior value on exit."""

    def __init__(self, enable: bool):
        self.enable = enable

    def __enter__(self):
        self.prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", self.enable)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.prev)


def _instances(seed, num_layers=5, num_servers=3, num_clients=2):
    """The conftest ``small_instance`` built in both packages."""
    ref = (R.random_profile(np.random.default_rng(seed), num_layers),
           R.make_edge_network(num_servers=num_servers,
                               num_clients=num_clients, seed=seed))
    port = (T.random_profile(np.random.default_rng(seed), num_layers),
            T.make_edge_network(num_servers=num_servers,
                                num_clients=num_clients, seed=seed))
    return ref, port


def _as_ref(res):
    """A port MSPResult with the reference's SplitSolution type."""
    sol = R.SplitSolution(res.solution.cuts, res.solution.placement)
    return dataclasses.replace(res, solution=sol)


def _within_contract(want, got, dtype):
    """The reference's contract: bit for bit in float64; in float32 equal
    feasibility, the objective within rtol ``parity_tolerance`` and the
    same b."""
    if dtype == torch.float64:
        return same_msp_result(want, _as_ref(got))
    if want.feasible != got.feasible:
        return False
    return (not want.feasible or (
        got.objective == pytest.approx(want.objective,
                                       rel=PD.parity_tolerance(dtype))
        and got.b == want.b))


def test_parity_tolerance():
    assert PD.parity_tolerance(torch.float64) == 0.0
    assert PD.parity_tolerance(torch.float32) == 1e-4
    with pytest.raises(ValueError):
        PD.parity_tolerance(torch.float16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dist_at_device_parity(dtype):
    """dist(t) over the quickstart's thresholds at b = 16: float64 equal
    to the reference's numpy sweep and to its jax sweep under x64; float32
    within rtol 1e-4 with the same finite entries."""
    rp, rn = R.vgg16_profile(work_units="bytes"), R.make_edge_network(
        6, 4, seed=1, kappa=1 / 32.0)
    tp, tn = T.vgg16_profile(work_units="bytes"), T.make_edge_network(
        6, 4, seed=1, kappa=1 / 32.0)
    rdp = R_LayeredDP(R.build_graph(rp, rn, 16), 7)
    betas = rdp.all_betas()
    ts = betas[::max(1, len(betas) // 24)]
    want = rdp.dist_at(ts)
    pl = T.Planner(tp, tn, device="cpu")
    dp = pl._dp(16, 7)
    got = PD.dist_at_device(dp, torch.from_numpy(ts), pl, dtype)
    assert got.dtype == torch.float64
    got = got.numpy()
    finite = np.isfinite(want)
    assert (finite == np.isfinite(got)).all()
    if dtype == torch.float64:
        with _x64(True):
            want_jax = rdp.dist_at(ts, backend="jax")
        assert np.array_equal(got, want) and np.array_equal(got, want_jax)
    else:
        assert np.allclose(got[finite], want[finite],
                           rtol=PD.parity_tolerance(dtype))
        assert not np.array_equal(got, want)      # it ran in float32


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 11])
def test_solve_backend_device_matches_reference(seed):
    (rp, rn), (tp, tn) = _instances(seed)
    B = 32
    for b in (4, 13):
        want = R.Planner(rp, rn).solve(b, B, solver="batched")
        for dtype in DTYPES:
            got = T.Planner(tp, tn, device="cpu").solve(
                b, B, solver="batched", backend="device", dtype=dtype)
            assert _within_contract(want, got, dtype), (dtype, want, got)
        with _x64(True):
            want_jax = R.Planner(rp, rn).solve(b, B, solver="batched",
                                               backend="jax")
        got64 = T.Planner(tp, tn, device="cpu").solve(
            b, B, backend="device", dtype=torch.float64)
        assert same_msp_result(want_jax, _as_ref(got64))


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_solve_many_backend_device_matches_reference(seed):
    (rp, rn), (tp, tn) = _instances(seed)
    B = 32
    bs = list(range(1, B + 1, 5))
    want = R.Planner(rp, rn).solve_many(bs, B)
    for dtype in DTYPES:
        got = T.Planner(tp, tn, device="cpu").solve_many(
            bs, B, backend="device", dtype=dtype)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            assert _within_contract(w, g, dtype), (dtype, w, g)
            if dtype == torch.float64:
                assert w.thresholds_scanned == g.thresholds_scanned


def test_solve_many_device_bit_exact_with_reference_jax_x64():
    (rp, rn), (tp, tn) = _instances(5, num_layers=6, num_servers=4)
    bs = [2, 7, 16, 31]
    with _x64(True):
        want = R.Planner(rp, rn).solve_many(bs, 32, backend="jax")
    got = T.Planner(tp, tn, device="cpu").solve_many(
        bs, 32, backend="device", dtype=torch.float64)
    exact = T.Planner(tp, tn, device="cpu").solve_many(bs, 32)
    for w, g, e in zip(want, got, exact):
        assert same_msp_result(w, _as_ref(g)), (w, g)
        assert same_msp_result(_as_ref(e), _as_ref(g))


@pytest.mark.parametrize("dtype", DTYPES)
def test_exhaustive_joint_backend_device(dtype):
    (rp, rn), (tp, tn) = _instances(4, num_layers=6, num_servers=3)
    want = R.exhaustive_joint(rp, rn, 48, b_step=3)
    got = T.exhaustive_joint(tp, tn, 48, b_step=3, device="cpu",
                             backend="device", dtype=dtype)
    assert want.feasible == got.feasible
    if dtype == torch.float64:
        assert (got.solution.cuts, got.solution.placement, got.b,
                got.L_t) == (want.solution.cuts, want.solution.placement,
                             want.b, want.L_t)
    else:
        assert got.L_t == pytest.approx(want.L_t, rel=1e-4)


# -- counters, restrictions and the two halves of the backend ---------------


def test_device_dispatch_counter_and_k1_calls(monkeypatch):
    """Phases A, P and D are stack sweeps, B and C one K1 call each."""
    (_, _), (tp, tn) = _instances(2)
    k1 = []
    real = PD.sweep_minplus

    def counted(*args, **kw):
        k1.append(kw.get("graph"))
        return real(*args, **kw)

    monkeypatch.setattr(PD, "sweep_minplus", counted)
    obs.reset()
    with obs.enabled_scope():
        T.Planner(tp, tn, device="cpu").solve_many([4, 8, 12], 32,
                                                   backend="device")
        assert obs.counter("planner.device_dispatches") >= 4
    obs.reset()
    assert len(k1) == 2 and all(g is not None for g in k1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_restricted_dp_under_device_runs_masked_sweeps(dtype):
    """A restricted DP keeps the exact masked sweep under the device
    backend (as the reference keeps it on numpy): masked sweeps counted,
    the result the exact backend's."""
    (rp, rn), (tp, tn) = _instances(1, num_layers=6, num_servers=3)
    cuts = (2, 4, 6)
    want = R.Planner(rp, rn).solve(8, 32, K=len(cuts), restrict_cuts=cuts)
    obs.reset()
    with obs.enabled_scope():
        got = T.Planner(tp, tn, device="cpu").solve(
            8, 32, K=len(cuts), restrict_cuts=cuts, backend="device",
            dtype=dtype)
        assert obs.counter("planner.masked_sweeps") > 0
        assert obs.counter("planner.device_dispatches") == 0
    obs.reset()
    assert same_msp_result(want, _as_ref(got))


def test_unknown_backend_or_dtype_raises():
    (_, _), (tp, tn) = _instances(0)
    pl = T.Planner(tp, tn, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        pl.solve(4, 32, backend="jax")
    with pytest.raises(ValueError, match="unknown backend"):
        pl.solve_many([4], 32, backend="numpy")
    with pytest.raises(ValueError, match="dtype"):
        pl.solve_many([4], 32, backend="device", dtype=torch.float16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_mirror_is_the_assembled_graph(dtype):
    """The mirror equals the exact DP's buffers bit for bit in float64
    (structural folds included) and within float32 rounding in float32."""
    (_, _), (tp, tn) = _instances(3, num_layers=6, num_servers=4)
    pl = T.Planner(tp, tn, device="cpu")
    want = pl._dp(9, pl.default_K(None)).mirror()
    got = PD.host_mirror(pl.factory, 9, dtype)
    for w, g in zip(want, got):
        assert g.dtype == np.dtype(str(dtype).split(".")[1])
        fin = np.isfinite(w)
        assert (fin == np.isfinite(g)).all()
        if dtype == torch.float64:
            assert np.array_equal(w, g)
        else:
            assert np.allclose(g[fin], w[fin], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 6])
def test_backtrace_stack_equals_parent_walk(seed):
    """A path rebuilt from a dist stack equals the parent-tracking walk of
    the same sweep (first-minimum ties included), at every threshold."""
    (_, _), (tp, tn) = _instances(seed, num_layers=7, num_servers=4)
    pl = T.Planner(tp, tn, device="cpu")
    dp = pl._dp(6, pl.default_K(None))
    ts = torch.cat([dp.all_betas(), torch.tensor([float("inf")],
                                                 dtype=torch.float64)])
    out = dp.sweep(ts, want_parents=True, want_stack=True)
    checked = 0
    for s in range(ts.numel()):
        k = int(out.best_k[s])
        if k == 0:
            continue
        m = int(out.best_m[s])
        want = _walk_parents(out.parents, s, k, m, dp.I)
        got = PD.backtrace_stack(stack_column(out.stack, s), dp.mirror(),
                                 float(ts[s]), k, m, dp.I)
        assert got == want, (s, got, want)
        checked += 1
    assert checked > 0
