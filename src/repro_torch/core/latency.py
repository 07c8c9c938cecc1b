"""Latency model — Eqs. (1)-(14), the port's copy of ``repro/core/latency.py``.

Closed-form scalar math stays host-side in Python floats, with the same
operations in the same order as the reference, so every number is bit-equal.

A solution is ``SplitSolution(cuts, placement)``:

  cuts[k]      last layer (1-based) of submodel k (k = 0..K-1, python index),
               non-decreasing, ``cuts[-1] == I``; ``cuts[k] == cuts[k-1]``
               encodes an *empty* submodel (paper C4/C5 allow this).
  placement[k] node index hosting submodel k; ``placement[0] == 0`` always
               (the virtual client node).

Equations: (1) client micro-batch shares; (2)+(3) FP latency; (5)+(6)
activation bytes and forward comm; (7)+(8) piecewise BP latency; (9)+(10)
act-grad bytes and backward comm; (11) memory footprint; (12) T_f fill
latency; (13) T_i pipeline interval; (14) L_t = T_f + ceil((B-b)/b) * T_i.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .network import EdgeNetwork
from .profiles import ModelProfile


@dataclasses.dataclass(frozen=True)
class SplitSolution:
    cuts: tuple          # length K, 1-based last layer per submodel
    placement: tuple     # length K, node index per submodel

    def __post_init__(self):
        object.__setattr__(self, "cuts", tuple(int(c) for c in self.cuts))
        object.__setattr__(self, "placement",
                           tuple(int(p) for p in self.placement))

    @property
    def K(self) -> int:
        return len(self.cuts)

    def segments(self):
        """Yield (k, lo, hi, node) for non-empty submodels; layers (lo, hi]."""
        lo = 0
        for k, (hi, node) in enumerate(zip(self.cuts, self.placement)):
            if hi > lo:
                yield k, lo, hi, node
            lo = hi

    def stage_of_layer(self, layer: int) -> int:
        """1-based layer -> submodel index k."""
        for k, lo, hi, _ in self.segments():
            if lo < layer <= hi:
                return k
        raise ValueError(f"layer {layer} not covered")


def validate_solution(sol: SplitSolution, profile: ModelProfile,
                      net: EdgeNetwork) -> None:
    """Raise ``ValueError`` (the reference's messages) unless ``sol`` is a
    well-formed split/placement of ``profile`` over ``net`` (C4-C6, Eq. 21)."""
    K, I = sol.K, profile.num_layers
    if sol.cuts[-1] != I:
        raise ValueError(f"last cut must equal I={I}, got {sol.cuts[-1]}")
    if any(sol.cuts[k] > sol.cuts[k + 1] for k in range(K - 1)):
        raise ValueError("cuts must be non-decreasing (C5)")
    if any(c < 1 or c > I for c in sol.cuts):
        raise ValueError("cuts out of range (C4)")
    if sol.placement[0] != 0:
        raise ValueError("submodel 1 must sit on the client tier (y_1,client=1)")
    if any(p < 0 or p >= len(net.nodes) for p in sol.placement):
        raise ValueError("placement out of range (C6)")
    segs = list(sol.segments())
    for (k1, _, _, n1), (k2, _, _, n2) in zip(segs, segs[1:]):
        if n1 == n2:
            raise ValueError(
                f"consecutive submodels {k1},{k2} share node {n1} (Eq. 21 n != n')")
    if len(segs) >= 2 and any(n == 0 for _, _, _, n in segs[1:]):
        raise ValueError("server submodels cannot sit on the client tier")


# ---------------------------------------------------------------------------
# Eq. (1): client shares
# ---------------------------------------------------------------------------

def client_shares(b: int, M: int) -> np.ndarray:
    base = b // M
    shares = np.full(M, base, dtype=np.int64)
    shares[-1] = b - (M - 1) * base
    return shares


def client_max_share(b: int, M: int) -> int:
    """The slowest client's share — the arg of the max terms in Eq. (12)."""
    return int(b - (M - 1) * (b // M))


# ---------------------------------------------------------------------------
# Eqs. (2)-(11): per-stage / per-link components
# ---------------------------------------------------------------------------

def fp_work(profile: ModelProfile, net: EdgeNetwork, lo: int, hi: int,
            node: int, b: int) -> float:
    """Eq. (2)'s rate-scaled work term: eff_b * kappa_n * delta^F_k."""
    n = net.nodes[node]
    eff_b = client_max_share(b, net.num_clients) if node == 0 else b
    return eff_b * n.kappa * profile.seg_fp(lo, hi)


def bp_work(profile: ModelProfile, net: EdgeNetwork, lo: int, hi: int,
            node: int, b: int) -> float:
    """Eq. (7)'s rate-scaled work term (0 below the b_th threshold)."""
    n = net.nodes[node]
    eff_b = client_max_share(b, net.num_clients) if node == 0 else b
    if eff_b <= n.b_th:
        return 0.0
    return (eff_b - n.b_th) * n.kappa * profile.seg_bp(lo, hi)


def fp_latency(profile: ModelProfile, net: EdgeNetwork, lo: int, hi: int,
               node: int, b: int) -> float:
    """Eq. (2): FP latency of submodel (lo, hi] on ``node`` for b samples
    (the largest-share client defines the client tier's latency)."""
    n = net.nodes[node]
    return fp_work(profile, net, lo, hi, node, b) / n.f + (n.t0)


def bp_latency(profile: ModelProfile, net: EdgeNetwork, lo: int, hi: int,
               node: int, b: int) -> float:
    """Eq. (7): piecewise BP latency with threshold b_th."""
    n = net.nodes[node]
    w = bp_work(profile, net, lo, hi, node, b)
    if w == 0.0:
        return float(n.t1)
    return w / n.f + n.t1


def fwd_bytes(profile: ModelProfile, net: EdgeNetwork, cut: int, b: int,
              from_client: bool) -> float:
    """Eq. (5): D_k — activation bytes crossing the cut after layer ``cut``."""
    eff_b = client_max_share(b, net.num_clients) if from_client else b
    return eff_b * profile.cut_act_bytes(cut)


def bwd_bytes(profile: ModelProfile, net: EdgeNetwork, cut: int, b: int,
              to_client: bool) -> float:
    """Eq. (9): D'_k — act-gradient bytes crossing the cut backwards."""
    eff_b = client_max_share(b, net.num_clients) if to_client else b
    return eff_b * profile.cut_grad_bytes(cut)


def comm_latency(net: EdgeNetwork, n_from: int, n_to: int, nbytes: float) -> float:
    """Eqs. (6)/(10): transfer latency over the (possibly multi-hop) link."""
    if nbytes == 0.0:
        return 0.0
    r = net.rate[n_from, n_to]
    if r <= 0:
        return math.inf
    return nbytes / r


def memory_split(profile: ModelProfile, net: EdgeNetwork, lo: int, hi: int,
                 node: int, b: int, model: str = "paper") -> tuple:
    """Eq. (11) split into ``(static_bytes, act_bytes)`` for one submodel.

    ``static_bytes`` is resident regardless of how many micro-batches are in
    flight; ``act_bytes`` is the footprint of ONE live micro-batch of size
    ``b``.  Under ``model='paper'`` Eq. (11) scales the *whole* footprint
    with b, so everything lands in the act term; ``'refined'`` scales only
    activations/grads."""
    static, per_sample = memory_split_per_sample(profile, lo, hi, model)
    eff_b = client_max_share(b, net.num_clients) if node == 0 else b
    return static, eff_b * per_sample


def memory_split_per_sample(profile: ModelProfile, lo: int, hi: int,
                            model: str = "paper") -> tuple:
    """The b-independent core of :func:`memory_split`:
    ``(static_bytes, act_bytes_per_sample)``."""
    if model == "paper":
        return 0.0, profile.seg_mem_per_sample(lo, hi)
    act = (profile.act_cum() + profile.grad_cum())
    static = (profile.param_cum() + profile.opt_cum())
    seg = lambda c: float(c[hi - 1] - (c[lo - 1] if lo > 0 else 0.0))
    return seg(static), seg(act)


def memory_bytes(profile: ModelProfile, net: EdgeNetwork, lo: int, hi: int,
                 node: int, b: int, model: str = "paper") -> float:
    """Eq. (11): eta_k — the footprint with one micro-batch in flight."""
    static, act = memory_split(profile, net, lo, hi, node, b, model)
    return act + static


# ---------------------------------------------------------------------------
# Breakdown: every (stage compute / link comm) component of a solution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LatencyBreakdown:
    """Per-component times for one micro-batch of size b."""
    stage_fp: dict       # k -> seconds
    stage_bp: dict       # k -> seconds
    link_fwd: dict       # (k, n_from, n_to) -> seconds
    link_bwd: dict       # (k, n_from, n_to) -> seconds
    node_of_stage: dict  # k -> node index

    def node_fp_sums(self):
        out = {}
        for k, t in self.stage_fp.items():
            n = self.node_of_stage[k]
            out[n] = out.get(n, 0.0) + t
        return out

    def node_bp_sums(self):
        out = {}
        for k, t in self.stage_bp.items():
            n = self.node_of_stage[k]
            out[n] = out.get(n, 0.0) + t
        return out

    def pair_fwd_sums(self):
        out = {}
        for (_, a, c), t in self.link_fwd.items():
            out[(a, c)] = out.get((a, c), 0.0) + t
        return out

    def pair_bwd_sums(self):
        out = {}
        for (_, a, c), t in self.link_bwd.items():
            out[(a, c)] = out.get((a, c), 0.0) + t
        return out


def breakdown(profile: ModelProfile, net: EdgeNetwork, sol: SplitSolution,
              b: int) -> LatencyBreakdown:
    segs = list(sol.segments())
    stage_fp, stage_bp, link_fwd, link_bwd, node_of = {}, {}, {}, {}, {}
    for k, lo, hi, node in segs:
        stage_fp[k] = fp_latency(profile, net, lo, hi, node, b)
        stage_bp[k] = bp_latency(profile, net, lo, hi, node, b)
        node_of[k] = node
    for (k1, _, hi1, n1), (_, _, _, n2) in zip(segs, segs[1:]):
        fb = fwd_bytes(profile, net, hi1, b, from_client=(n1 == 0))
        gb = bwd_bytes(profile, net, hi1, b, to_client=(n1 == 0))
        link_fwd[(k1, n1, n2)] = comm_latency(net, n1, n2, fb)
        link_bwd[(k1, n2, n1)] = comm_latency(net, n2, n1, gb)
    return LatencyBreakdown(stage_fp, stage_bp, link_fwd, link_bwd, node_of)


# ---------------------------------------------------------------------------
# Eqs. (12)-(14)
# ---------------------------------------------------------------------------

def fill_latency(profile: ModelProfile, net: EdgeNetwork, sol: SplitSolution,
                 b: int) -> float:
    """Eq. (12): T_f — one micro-batch traverses FP then BP over the chain."""
    bd = breakdown(profile, net, sol, b)
    return (sum(bd.stage_fp.values()) + sum(bd.stage_bp.values()) +
            sum(bd.link_fwd.values()) + sum(bd.link_bwd.values()))


def pipeline_interval(profile: ModelProfile, net: EdgeNetwork,
                      sol: SplitSolution, b: int) -> float:
    """Eq. (13): T_i — the bottleneck component.  Per C9-C16 the per-node
    terms sum over co-located submodels, and FP/BP (and fwd/bwd links) are
    separate pipeline resources."""
    bd = breakdown(profile, net, sol, b)
    candidates = (list(bd.node_fp_sums().values()) +
                  list(bd.node_bp_sums().values()) +
                  list(bd.pair_fwd_sums().values()) +
                  list(bd.pair_bwd_sums().values()))
    return max(candidates) if candidates else 0.0


def num_fills(B: int, b: int) -> int:
    """xi(b) = ceil((B - b)/b): extra pipeline slots after the first."""
    return math.ceil((B - b) / b)


def total_latency(profile: ModelProfile, net: EdgeNetwork, sol: SplitSolution,
                  b: int, B: int) -> float:
    """Eq. (14): L_t = T_f + ceil((B-b)/b) * T_i."""
    return (fill_latency(profile, net, sol, b) +
            num_fills(B, b) * pipeline_interval(profile, net, sol, b))


def no_pipeline_latency(profile: ModelProfile, net: EdgeNetwork,
                        sol: SplitSolution, B: int) -> float:
    """The 'No Pipeline' benchmark: the whole mini-batch goes through as one
    micro-batch (b = B) — Eq. (14) degenerates to T_f(B)."""
    return fill_latency(profile, net, sol, B)


# ---------------------------------------------------------------------------
# Feasibility (C7, C8)
# ---------------------------------------------------------------------------

def node_memory_usage(profile: ModelProfile, net: EdgeNetwork,
                      sol: SplitSolution, b: int,
                      model: str = "paper") -> dict:
    usage = {}
    for k, lo, hi, node in sol.segments():
        usage[node] = usage.get(node, 0.0) + memory_bytes(
            profile, net, lo, hi, node, b, model)
    return usage


def memory_feasible(profile: ModelProfile, net: EdgeNetwork,
                    sol: SplitSolution, b: int, model: str = "paper") -> bool:
    for node, used in node_memory_usage(profile, net, sol, b, model).items():
        if used > net.nodes[node].mem:
            return False
    return True


def max_feasible_microbatch(profile: ModelProfile, net: EdgeNetwork,
                            sol: SplitSolution, B: int,
                            model: str = "paper") -> int:
    """Largest b in [1, B] satisfying C7/C8 (memory is monotone in b)."""
    lo_b, hi_b = 1, B
    if not memory_feasible(profile, net, sol, 1, model):
        return 0
    while lo_b < hi_b:
        mid = (lo_b + hi_b + 1) // 2
        if memory_feasible(profile, net, sol, mid, model):
            lo_b = mid
        else:
            hi_b = mid - 1
    return lo_b
