"""Shared fixtures.  NOTE: no XLA_FLAGS here by design — tests see 1 CPU
device; multi-device tests spawn subprocesses (see tests/test_spmd.py)."""

import numpy as np
import pytest

from repro.core import make_edge_network, vgg16_profile, random_profile


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running checks (wall-clock measurements); deselect "
        "with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "pallas: kernel parity tests; skip (not fail) where the Pallas "
        "lowering toolchain is unavailable")
    config.addinivalue_line(
        "markers",
        "cuda: tests of the PyTorch port's CUDA kernels; skip (not fail) "
        "where no GPU is visible")


@pytest.fixture
def vgg_profile():
    return vgg16_profile(work_units="bytes")


@pytest.fixture
def paper_network():
    """Table-II-style 6-server network (kappa = 1/32 to match byte units)."""
    return make_edge_network(num_servers=6, num_clients=4, seed=1,
                             kappa=1 / 32.0)


def small_instance(seed: int, num_layers: int = 6, num_servers: int = 3,
                   num_clients: int = 2):
    rng = np.random.default_rng(seed)
    prof = random_profile(rng, num_layers)
    net = make_edge_network(num_servers=num_servers,
                            num_clients=num_clients, seed=seed)
    return prof, net


def same_msp_result(r1, r2):
    """The scan == batched contract: bit-identical searched result."""
    if r1.feasible != r2.feasible:
        return False
    if not r1.feasible:
        return True
    return (r1.objective == r2.objective and r1.solution == r2.solution
            and r1.T_1 == r2.T_1 and r1.T_f == r2.T_f and r1.b == r2.b)
