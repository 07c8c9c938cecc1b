"""The port's GPU stage planner (``repro_torch/core/planner.py``,
``core/network.py::stage_network``) and ``plan_to_pipeline_config``
against the reference's TPU stage planner, on the CPU.

Given the reference's TPU constants every field of every plan is ``==``
the reference's (the planner is float64 ``+`` / ``max`` / ``min`` and the
same closed forms), for the qwen3-0.6b, llama3-8b and granite-moe-3b
profiles over 256 and 16 chips; so is ``replan`` seeded with the previous
plan.  With the H100 defaults the port plans a pipeline of its own; the
reference, handed the same constants, plans the same.
"""

import math

import numpy as np
import pytest
import torch

from repro.configs import arch_profile as ref_profile
from repro.configs import get_config as ref_config
from repro.core import plan_stages as ref_plan_stages
from repro.core import replan as ref_replan
from repro.core.network import (TPU_HBM_BYTES, TPU_ICI_BW, TPU_PEAK_FLOPS,
                                tpu_stage_network)
from repro.pipeline import plan_to_pipeline_config as ref_pipeline_config

from repro_torch.configs import arch_profile, get_config
from repro_torch.core import network, plan_stages, replan, stage_network
from repro_torch.pipeline.spmd import plan_to_pipeline_config

CPU = "cpu"
ARCHS = ("qwen3-0.6b", "llama3-8b", "granite-moe-3b-a800m")
CHIPS = (256, 16)
CANDIDATES = (2, 4, 8, 16)
TPU = {"peak_flops": TPU_PEAK_FLOPS, "hbm_bytes": TPU_HBM_BYTES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(sp) -> tuple:
    p = sp.plan
    return (sp.layer_ranges, sp.num_stages, sp.microbatch,
            sp.num_microbatches, sp.T_f, sp.T_i, sp.L_t, sp.bubble_fraction,
            tuple(p.solution.cuts), tuple(p.solution.placement), p.b, p.B,
            p.T_f, p.T_i, p.L_t)


def _profiles(arch):
    return ref_profile(ref_config(arch)), arch_profile(get_config(arch))


@pytest.mark.parametrize("chips", CHIPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_stages_equals_the_reference_with_tpu_constants(arch, chips):
    ref_prof, prof = _profiles(arch)
    want = ref_plan_stages(ref_prof, total_chips=chips,
                           stage_candidates=CANDIDATES, global_batch=256)
    got = plan_stages(prof, total_chips=chips, stage_candidates=CANDIDATES,
                      global_batch=256, link_bw=TPU_ICI_BW, device=CPU,
                      **TPU)
    assert _fields(got) == _fields(want)
    assert plan_to_pipeline_config(got, 256) == \
        type(plan_to_pipeline_config(got, 256))(
            **vars(ref_pipeline_config(want, 256)))
    for layer in (0, prof.num_layers - 1):
        assert got.stage_of_layer(layer) == want.stage_of_layer(layer)


@pytest.mark.parametrize("chips", CHIPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_replan_equals_the_reference(arch, chips):
    """An elastic replan after losing half the chips, seeded with the
    previous plan's micro-batch."""
    ref_prof, prof = _profiles(arch)
    prev_ref = ref_plan_stages(ref_prof, total_chips=chips,
                               stage_candidates=CANDIDATES, global_batch=256)
    prev = plan_stages(prof, total_chips=chips, stage_candidates=CANDIDATES,
                       global_batch=256, link_bw=TPU_ICI_BW, device=CPU,
                       **TPU)
    want = ref_replan(ref_prof, total_chips=chips // 2, global_batch=128,
                      prev=prev_ref, stage_candidates=CANDIDATES)
    got = replan(prof, total_chips=chips // 2, global_batch=128, prev=prev,
                 stage_candidates=CANDIDATES, link_bw=TPU_ICI_BW,
                 device=CPU, **TPU)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("q,batch", [(1, 8), (8, 8), (6, 8), (5, 12),
                                     (300, 256)])
def test_plan_to_pipeline_config_takes_the_references_q(q, batch):
    class Plan:
        num_stages, num_microbatches = 4, q
    want = ref_pipeline_config(Plan, batch)
    got = plan_to_pipeline_config(Plan, batch)
    assert (got.num_stages, got.num_microbatches, got.stage_axis) == \
        (want.num_stages, want.num_microbatches, want.stage_axis)


@pytest.mark.parametrize("stages,per", [(2, 128), (4, 4), (8, 1)])
def test_stage_network_with_tpu_constants_is_the_references(stages, per):
    want = tpu_stage_network(stages, per)
    got = stage_network(stages, per, link_bw=TPU_ICI_BW, **TPU)
    assert np.array_equal(got.rate, want.rate)
    assert [vars(n) for n in got.nodes] == [vars(n) for n in want.nodes]
    assert (got.num_clients, got.topology) == (want.num_clients,
                                               want.topology)


def test_h100_constants_and_default_link():
    assert network.H100_PEAK_FLOPS == 989e12
    assert network.H100_HBM_BW == 3.35e12
    assert network.H100_HBM_BYTES == 80e9
    assert network.H100_NVLINK_BW == 900e9 / 2
    assert network.H100_IB_BW == 400e9 / 8
    net = stage_network(4, 8)
    assert net.nodes[1].f == 8 * 989e12 and net.nodes[1].mem == 8 * 80e9
    assert net.rate[0, 1] == network.H100_IB_BW
    # two hops forward store-and-forward: half the rate
    assert net.rate[0, 2] == pytest.approx(network.H100_IB_BW / 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_h100_defaults_give_a_feasible_plan(arch):
    ref_prof, prof = _profiles(arch)
    got = plan_stages(prof, total_chips=16, stage_candidates=CANDIDATES,
                      global_batch=256, device=CPU)
    assert got.num_stages in CANDIDATES
    assert got.plan.solution.placement == tuple(range(got.num_stages))
    assert 1 <= got.microbatch <= 256
    assert got.T_i > 0 and got.L_t >= got.T_f
    assert 0.0 <= got.bubble_fraction < 1.0
    assert got.num_microbatches == math.ceil(256 / got.microbatch)
    want = ref_plan_stages(ref_prof, total_chips=16,
                           stage_candidates=CANDIDATES, global_batch=256,
                           peak_flops=network.H100_PEAK_FLOPS,
                           hbm_bytes=network.H100_HBM_BYTES,
                           ici_bw=network.H100_IB_BW)
    assert _fields(got) == _fields(want)


def test_the_card_phases_plan():
    """The plan ``chip_smoke.py``'s pipeline phase prints: qwen3-0.6b on 2
    GPUs, 2 stages, a batch of 8.  Seeded at b0 = 8 (the whole batch) BCD
    stays at one stage and Q = 1; seeded at b0 = 1 it splits the layers
    over both stages with Q = 8 and a lower L_t."""
    prof = arch_profile(get_config("qwen3-0.6b"))
    whole = plan_stages(prof, total_chips=2, stage_candidates=(2,),
                        global_batch=8, device=CPU)
    assert (whole.num_stages, whole.num_microbatches) == (1, 1)
    split = plan_stages(prof, total_chips=2, stage_candidates=(2,),
                        global_batch=8, b0=1, device=CPU)
    assert (split.num_stages, split.num_microbatches) == (2, 8)
    assert split.L_t < whole.L_t
    assert plan_to_pipeline_config(split, 8).num_microbatches == 8
