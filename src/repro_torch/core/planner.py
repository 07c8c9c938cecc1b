"""GPU stage planner — the paper's MSP + micro-batching, aimed at a pipeline
of H100 stage groups; the port of ``repro/core/planner.py``.

Hardware mapping: nodes become homogeneous *stage groups* (GPUs x 989
TFLOP/s bf16, 80 GB HBM3 each), links become the interconnect between
groups (NDR InfiniBand by default; ``core/network.py::stage_network``), and
placement is *ordered* (stage k -> group k), so Algorithm 1 runs with
``restrict_placement = (0, 1, .., S-1)``: cuts balance per-stage compute
against inter-stage activation traffic, and Theorem 1 picks the pipeline
micro-batch size.  Under ``restrict_placement`` the planner takes the
masked plain sweep on its device, never K1.

The planner tries several stage counts and returns the best plan;
``replan`` re-runs it after an elastic event (a lost stage group, a changed
link bandwidth).  Given the reference's TPU constants every field equals
the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from . import latency as L
from .bcd import Plan
from .microbatch import optimal_microbatch
from .network import (H100_HBM_BYTES, H100_IB_BW, H100_PEAK_FLOPS,
                      EdgeNetwork, stage_network)
from .profiles import ModelProfile
from .shortest_path import Planner


@dataclasses.dataclass
class StagePlan:
    """Layer ranges per pipeline stage + micro-batching, ready for
    ``pipeline/spmd.py``."""
    layer_ranges: tuple        # ((lo, hi), ...) per stage, 0-based cut points
    num_stages: int
    microbatch: int
    num_microbatches: int
    T_f: float
    T_i: float
    L_t: float
    bubble_fraction: float     # (L_t - Q T_i) / L_t, GPipe-style
    plan: Plan

    def stage_of_layer(self, layer: int) -> int:
        for s, (lo, hi) in enumerate(self.layer_ranges):
            if lo <= layer < hi:
                return s
        raise ValueError(layer)


def _solve_fixed_stages(profile: ModelProfile, net: EdgeNetwork, B: int,
                        num_stages: int, b0: int,
                        device="cuda") -> Plan | None:
    # resident weights: params / optimizer state do not scale with the
    # micro-batch (the paper's Eq. 11 multiplies everything by b, right for
    # edge servers swapping whole submodels) -> the "refined" memory model
    mm = "refined"
    placement = tuple(range(num_stages))
    b = max(1, min(b0, B))
    prev_L = math.inf
    plan = None
    planner = Planner(profile, net, mm, device=device)
    for _ in range(8):                       # BCD with ordered placement
        msp = planner.solve(b, B, K=num_stages,
                            restrict_placement=placement)
        if not msp.feasible:
            if b > 1:
                b = max(1, b // 2)
                continue
            return None
        mb = optimal_microbatch(profile, net, msp.solution, B, msp.T_1,
                                memory_model=mm)
        if mb.b > 0:
            b = mb.b
        L_t = L.total_latency(profile, net, msp.solution, b, B)
        plan = Plan(solution=msp.solution, b=b, B=B,
                    T_f=L.fill_latency(profile, net, msp.solution, b),
                    T_i=L.pipeline_interval(profile, net, msp.solution, b),
                    L_t=L_t, iterations=1, history=[], solve_seconds=0.0)
        if abs(prev_L - L_t) < 1e-6 * max(L_t, 1.0):
            break
        prev_L = L_t
    return plan


def plan_stages(profile: ModelProfile, *, total_chips: int,
                stage_candidates: Sequence[int] = (2, 4, 8, 16),
                global_batch: int = 256, b0: int = 8,
                peak_flops: float = H100_PEAK_FLOPS,
                hbm_bytes: float = H100_HBM_BYTES,
                link_bw: float = H100_IB_BW,
                device="cuda") -> StagePlan:
    """Pick (num_stages, cuts, micro-batch) minimizing Eq. (14) over
    ``total_chips`` GPUs, the planner on ``device`` (``"cuda"`` unless the
    caller passes ``"cpu"``).  ``link_bw`` is the reference's ``ici_bw``."""
    best: StagePlan | None = None
    for S in stage_candidates:
        if S > profile.num_layers or total_chips % S != 0:
            continue
        net = stage_network(S, total_chips // S, peak_flops=peak_flops,
                            hbm_bytes=hbm_bytes, link_bw=link_bw)
        plan = _solve_fixed_stages(profile, net, global_batch, S, b0, device)
        if plan is None:
            continue
        sp = _to_stage_plan(plan, S)
        if best is None or sp.L_t < best.L_t:
            best = sp
    if best is None:
        raise ValueError("no feasible stage plan (model too large per stage?)")
    return best


def _to_stage_plan(plan: Plan, S: int) -> StagePlan:
    segs = list(plan.solution.segments())
    ranges = tuple((lo, hi) for _, lo, hi, _ in segs)
    q = plan.num_microbatches
    bubble = (plan.L_t - q * plan.T_i) / plan.L_t if plan.L_t > 0 else 0.0
    return StagePlan(layer_ranges=ranges, num_stages=len(ranges),
                     microbatch=plan.b, num_microbatches=q,
                     T_f=plan.T_f, T_i=plan.T_i, L_t=plan.L_t,
                     bubble_fraction=max(bubble, 0.0), plan=plan)


def replan(profile: ModelProfile, *, total_chips: int, global_batch: int,
           prev: StagePlan | None = None, **kw) -> StagePlan:
    """Elastic re-plan after a resource change (``ft/coordinator.py``'s
    hook); seeds BCD with the previous micro-batch size."""
    b0 = prev.microbatch if prev is not None else 8
    return plan_stages(profile, total_chips=total_chips,
                       global_batch=global_batch, b0=b0, **kw)
