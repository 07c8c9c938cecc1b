"""Theorem 1 — optimal micro-batch size in closed form (Appendix A).

The port's copy of ``repro/core/microbatch.py``: host-side Python floats,
bit-equal to the reference.  With the MSP result (x, y) and the auxiliary
bottleneck T_1 fixed, P3 is

    min_b  T_f(b) + xi(b) * T_1,     xi(b) = ceil((B - b)/b)
    s.t.   b in [1, B],  memory (C7'/C8'),  T_i-components(b) <= T_1

T_f(b) is piecewise linear in b; relaxing the ceil gives the paper's
b~ = sqrt(B * T_1 / C_lin) per case of Eq. (18), clamped into the
feasibility box [1, min(b_v, B)] of Eq. (24) (computed exactly by binary
search on the monotone predicate).  ``exhaustive_microbatch`` scans every b
in [1, B] — the oracle the closed form is compared against.
"""

from __future__ import annotations

import dataclasses
import math

from . import latency as L
from .cost_model import resolve_cost_model
from .latency import SplitSolution, client_max_share
from .network import EdgeNetwork
from .profiles import ModelProfile


@dataclasses.dataclass
class MicrobatchResult:
    b: int
    objective: float         # T_f(b) + xi(b) * T_1   (the P3 objective)
    L_t: float               # true Eq. (14) latency at this b
    case: str                # which Theorem-1 case produced the winner
    b_v: int                 # feasibility box upper corner
    candidates: dict         # case -> b~ (pre-clamp), for inspection


def _linear_coeff(profile: ModelProfile, net: EdgeNetwork, sol: SplitSolution,
                  *, client_bp: bool, server_bp: bool) -> float:
    """dT_f/db with the chosen BP terms active (client slopes carry the 1/M
    share factor of Eq. (1), as the paper's closed form does)."""
    M = net.num_clients
    coeff = 0.0
    segs = list(sol.segments())
    for k, lo, hi, n in segs:
        node = net.nodes[n]
        share = (1.0 / M) if n == 0 else 1.0
        coeff += share * node.kappa * profile.seg_fp(lo, hi) / node.f
        include_bp = client_bp if n == 0 else server_bp
        if include_bp:
            coeff += share * node.kappa * profile.seg_bp(lo, hi) / node.f
    for (k1, _, hi1, n1), (_, _, _, n2) in zip(segs, segs[1:]):
        share = (1.0 / M) if n1 == 0 else 1.0
        r_f = net.rate[n1, n2]
        r_b = net.rate[n2, n1]
        coeff += share * profile.cut_act_bytes(hi1) / r_f
        coeff += share * profile.cut_grad_bytes(hi1) / r_b
    return coeff


def feasibility_box(profile: ModelProfile, net: EdgeNetwork,
                    sol: SplitSolution, B: int, T_1: float,
                    memory_model: str = "paper", cost_model=None) -> int:
    """Largest b in [1, B] with memory feasible AND T_i(b) <= T_1 (both
    monotone non-increasing in b, so binary search is exact)."""
    cm = resolve_cost_model(cost_model, memory_model)
    tol = 1.0 + 1e-9

    def ok(b: int) -> bool:
        if not cm.memory_feasible(profile, net, sol, b):
            return False
        return L.pipeline_interval(profile, net, sol, b) <= T_1 * tol

    if not ok(1):
        return 0
    lo, hi = 1, B
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _objective(profile, net, sol, b, B, T_1) -> float:
    return L.fill_latency(profile, net, sol, b) + L.num_fills(B, b) * T_1


def optimal_microbatch(profile: ModelProfile, net: EdgeNetwork,
                       sol: SplitSolution, B: int, T_1: float,
                       memory_model: str = "paper",
                       cost_model=None) -> MicrobatchResult:
    """Eq. (18): evaluate the four closed-form cases and pick the best
    feasible candidate under the exact P3 objective."""
    b_v = feasibility_box(profile, net, sol, B, T_1, memory_model,
                          cost_model=cost_model)
    if b_v == 0:
        return MicrobatchResult(b=0, objective=math.inf, L_t=math.inf,
                                case="infeasible", b_v=0, candidates={})
    hi = min(b_v, B)
    M = net.num_clients

    c_th = net.client.b_th
    server_ths = [net.nodes[n].b_th for _, _, _, n in sol.segments() if n != 0]
    s_th = min(server_ths) if server_ths else 0

    cases = {
        # (client_bp_linear, server_bp_linear, valid-range predicate)
        "b1_below_both": (False, False,
                          lambda b: client_max_share(b, M) <= c_th and b <= s_th),
        "b2_above_both": (True, True,
                          lambda b: client_max_share(b, M) >= c_th and b >= s_th),
        "b3_client_only": (True, False,
                           lambda b: client_max_share(b, M) >= c_th and b <= s_th),
        "b4_server_only": (False, True,
                           lambda b: client_max_share(b, M) <= c_th and b >= s_th),
    }

    best = None
    tilde = {}
    for name, (cb, sb, in_range) in cases.items():
        C_lin = _linear_coeff(profile, net, sol, client_bp=cb, server_bp=sb)
        if C_lin <= 0:
            b_t = float(hi)
        else:
            b_t = math.sqrt(B * T_1 / C_lin)
        tilde[name] = b_t
        for cand in {int(math.floor(b_t)), int(math.ceil(b_t)), 1, hi}:
            b = min(max(cand, 1), hi)
            obj = _objective(profile, net, sol, b, B, T_1)
            # in-range candidates rank first (paper Eq. 18); out-of-range
            # ones stay as tie-breakers — the exact objective decides
            rank = (0 if in_range(b) else 1, obj, b)
            if best is None or rank < best[0]:
                best = (rank, b, obj, name)
    _, b_star, obj, case = best
    return MicrobatchResult(
        b=b_star, objective=obj,
        L_t=L.total_latency(profile, net, sol, b_star, B),
        case=case, b_v=hi, candidates=tilde)


def exhaustive_microbatch(profile: ModelProfile, net: EdgeNetwork,
                          sol: SplitSolution, B: int, T_1: float | None = None,
                          memory_model: str = "paper", cost_model=None):
    """Oracle: argmin over all b in [1, B].

    With ``T_1`` given, minimizes the P3 objective under the same
    feasibility box; with ``T_1=None``, minimizes the cost model's
    objective (Eq. (14)'s L_t for the default ``ClosedForm``)."""
    cm = resolve_cost_model(cost_model, memory_model)
    best_b, best_val = 0, math.inf
    if T_1 is not None:
        for b in range(1, B + 1):
            if not cm.memory_feasible(profile, net, sol, b):
                continue
            if L.pipeline_interval(profile, net, sol, b) > T_1 * (1 + 1e-9):
                continue
            val = _objective(profile, net, sol, b, B, T_1)
            if val < best_val:
                best_val, best_b = val, b
        return best_b, best_val
    bs = list(range(1, B + 1))
    feas = [b for b, ok in zip(bs, cm.memory_feasible_many(profile, net,
                                                           sol, bs)) if ok]
    vals = cm.evaluate_many(profile, net, [(sol, b) for b in feas], B)
    for b, val in zip(feas, vals):
        if val < best_val:
            best_val, best_b = val, b
    return best_b, best_val
