"""Graph representation of the MSP problem (Sec. V-D, Eqs. 20-22).

The port of ``repro/core/msp_graph.py``.  The reachable-cost state of the
paper's layered graph is ``(k, n, i)`` = "the k-th (non-empty) submodel ends
at layer i on node n"; an edge ``(k, n, i) -> (k+1, n', j)`` (j > i, n' a
server, n' != n) carries the Eq. (22) weight folded onto its head vertex

    c = t^F_comm(cut i, n->n') + t^B_comm(cut i, n'->n)
      + t^F((i, j], n') + t^B((i, j], n')

and the bottleneck value ``beta = max(t^F_comm, t^B_comm, t^F_head,
t^B_head)``.  Everything is held as dense float64 tensors over the factored
edge space — communication terms over ``(i, n, n')`` and segment terms over
``(n', i, j)`` — on the planner's device.

``GraphFactory`` keeps the b-independent basis (cumulative segment
workloads, per-cut byte volumes, rates, node constants: cumulative sums, so
computed host-side in numpy exactly as the reference does) on the device,
and ``graph(b)`` assembles an :class:`MSPGraph` there with elementwise ops
only.  Every elementwise float64 op is exactly rounded on either device, so
the tensors are bit-equal to the reference's numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from .latency import SplitSolution, client_max_share
from .network import EdgeNetwork
from .profiles import ModelProfile

_F64 = torch.float64


@dataclasses.dataclass
class MSPGraph:
    """Dense float64 tensors over the layered edge space, on one device.

    Shapes: ``N`` nodes (index 0 = client tier), ``I`` layers.
      seg_cost[n, i, j]   compute (FP+BP) of segment (i, j] on node n; inf if
                          j <= i or memory-infeasible on n  (i, j in 0..I)
      seg_beta[n, i, j]   max(FP, BP) of that segment
      comm_cost[i, n, m]  fwd + bwd comm across cut i between nodes n -> m
      comm_beta[i, n, m]  max(fwd, bwd) across cut i
      src_cost[i]         client segment (0, i] compute cost (FP+BP)
      src_beta[i]         max(FP, BP) of the client segment
    """
    profile: ModelProfile
    net: EdgeNetwork
    b: int
    seg_cost: torch.Tensor
    seg_beta: torch.Tensor
    comm_cost: torch.Tensor
    comm_beta: torch.Tensor
    src_cost: torch.Tensor
    src_beta: torch.Tensor

    @property
    def I(self) -> int:
        return self.profile.num_layers

    @property
    def N(self) -> int:
        return len(self.net.nodes)

    def edge_cost(self, n: int, i: int, m: int, j: int) -> float:
        """Full edge weight (comm across cut i) + (head segment (i,j] on m)."""
        return float(self.comm_cost[i, n, m] + self.seg_cost[m, i, j])

    def edge_beta(self, n: int, i: int, m: int, j: int) -> float:
        return float(max(self.comm_beta[i, n, m], self.seg_beta[m, i, j]))


class GraphFactory:
    """b-independent precomputation for MSP graph assembly.

    ``graph(b)`` assembles an :class:`MSPGraph` by broadcasting:

        seg_cost(b) = eff(b) * kappa * delta^F / f + t0
                    + max(0, eff(b) - b_th) * kappa * delta^B / f + t1
        comm_cost(b) = eff(b) * phi_i / r_{nm} + eff(b) * phi'_i / r_{mn}

    where ``eff(b)`` is b for servers and the Eq. (1) max client share for
    the virtual client node.
    """

    def __init__(self, profile: ModelProfile, net: EdgeNetwork,
                 memory_model: str = "paper", device="cuda"):
        self.profile, self.net, self.memory_model = profile, net, memory_model
        self.device = resolve_device(device)
        I = profile.num_layers
        N = len(net.nodes)
        self.I, self.N = I, N
        I1 = I + 1

        dev, column = self._dev, self._column
        self.f = column([n.f for n in net.nodes])
        self.kappa = column([n.kappa for n in net.nodes])
        self.t0 = column([n.t0 for n in net.nodes])
        self.t1 = column([n.t1 for n in net.nodes])
        self.b_th = column([float(n.b_th) for n in net.nodes])
        self.mem = column([n.mem for n in net.nodes])

        # per-sample segment workloads over every (i, j] range, (I1, I1):
        # host-side cumulative sums (the same sequential order as numpy)
        def seg_table(per_layer: np.ndarray) -> torch.Tensor:
            c = np.concatenate([[0.0], np.cumsum(per_layer)])
            return dev(c[None, :] - c[:, None])   # [i, j] = cum[j] - cum[i]

        self.W_fp = seg_table(profile.fp_work)
        self.W_bp = seg_table(profile.bp_work)
        self.Mem_ps = seg_table(profile.act_bytes + profile.grad_bytes +
                                profile.param_bytes + profile.opt_bytes)
        self.Mem_act = seg_table(profile.act_bytes + profile.grad_bytes)
        self.Mem_static = seg_table(profile.param_bytes + profile.opt_bytes)
        self.tri = dev(np.arange(I1)[None, :] > np.arange(I1)[:, None])

        # per-sample byte volumes per cut i (row 0 unused -> inf comm)
        self.fb1 = dev(np.concatenate([[0.0], profile.act_bytes])[:, None])
        self.gb1 = dev(np.concatenate([[0.0], profile.grad_bytes])[:, None])
        self.rate = dev(net.rate)[None]                     # (1, N, N)
        self.rate_T = dev(net.rate.T)[None]

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _column(self, values) -> torch.Tensor:
        """(N, 1, 1) node constants on the device."""
        return self._dev(np.array(values, dtype=float)[:, None, None])

    # -- in-place patching (Planner.update) ---------------------------------
    def patch_rate(self, net: EdgeNetwork) -> None:
        """Rebind to a network whose ``rate`` matrix changed (same nodes).

        Only the rate tensors are swapped; cached graphs stay valid except
        for the comm entries of the changed link pair (:meth:`comm_pair`)."""
        self.net = net
        self.rate = self._dev(net.rate)[None]
        self.rate_T = self._dev(net.rate.T)[None]

    def patch_node_speed(self, net: EdgeNetwork) -> None:
        """Rebind to a network whose node ``f`` vector changed (same nodes,
        same rates) — the straggler mutation.  Cached graphs stay valid
        except the seg row of the changed node (:meth:`seg_node`)."""
        self.net = net
        self.f = self._column([n.f for n in net.nodes])

    def comm_pair(self, eff: np.ndarray, a: int, c: int):
        """``(comm_cost[:, a, c], comm_beta[:, a, c])`` columns, shape
        (I + 1,), for the *current* rate tensors: :meth:`graph`'s formula
        chain restricted to one (n, m) pair, so a patched column is bitwise
        equal to a fresh assembly.  Every divisor is a device tensor (torch
        turns a division by a host scalar on the GPU into a product with
        its reciprocal, which rounds differently)."""
        e = self._dev(float(eff[a]))
        fb = e * self.fb1[:, 0]          # (I1,) fwd bytes at cut i
        gb = e * self.gb1[:, 0]          # (I1,) bwd bytes at cut i
        # both byte volumes scale with eff of the *forward sender* a — the
        # gradient flows back to a, whose effective batch sizes the tensor
        r, rT = self.rate[0, a, c], self.rate_T[0, a, c]
        inf = torch.tensor(np.inf, dtype=_F64, device=self.device)
        zero = torch.zeros((), dtype=_F64, device=self.device)
        tf = torch.where(fb == 0.0, zero, torch.where(r > 0, fb / r, inf))
        tb = torch.where(gb == 0.0, zero, torch.where(rT > 0, gb / rT, inf))
        cost = tf + tb
        beta = torch.maximum(tf, tb)
        cost[0] = np.inf
        beta[0] = np.inf
        if a == c:
            cost[:] = np.inf
            beta[:] = np.inf
        return cost, beta

    def seg_node(self, eff: np.ndarray, n: int):
        """``(seg_cost[n], seg_beta[n])`` rows (I + 1, I + 1) for the
        *current* node constants: :meth:`graph`'s segment formulas
        restricted to one node, bitwise equal to a fresh assembly."""
        inf = torch.tensor(np.inf, dtype=_F64, device=self.device)
        e = self._dev(float(eff[n]))
        kappa, f, t0, t1 = (x[n] for x in (self.kappa, self.f, self.t0,
                                            self.t1))
        fp = (e * kappa) * self.W_fp / f + t0
        bp_w = (torch.clamp_min(e - self.b_th[n], 0.0) * kappa) * self.W_bp
        bp = torch.where(bp_w == 0.0, t1, bp_w / f + t1)
        if self.memory_model == "paper":
            mem_ok = e * self.Mem_ps <= self.mem[n]
        else:
            mem_ok = e * self.Mem_act + self.Mem_static <= self.mem[n]
        ok = self.tri & mem_ok
        return (torch.where(ok, fp + bp, inf),
                torch.where(ok, torch.maximum(fp, bp), inf))

    def effective_batch(self, b: int) -> np.ndarray:
        """Per-node effective micro-batch: Eq. (1) max share on the client
        tier (node 0), b everywhere else."""
        eff = np.full(self.N, float(b))
        eff[0] = float(client_max_share(b, self.net.num_clients))
        return eff

    def graph(self, b: int) -> MSPGraph:
        """Assemble the dense MSPGraph for micro-batch size b (elementwise
        ops only, in the reference's order)."""
        inf = torch.tensor(np.inf, dtype=_F64, device=self.device)
        eff_np = self.effective_batch(b)
        eff = torch.as_tensor(eff_np, device=self.device)

        # segments: (N, I1, I1) over [n, i, j]
        e = eff[:, None, None]
        fp = (e * self.kappa) * self.W_fp[None] / self.f + self.t0
        bp_w = (torch.clamp_min(e - self.b_th, 0.0)
                * self.kappa) * self.W_bp[None]
        bp = torch.where(bp_w == 0.0, self.t1, bp_w / self.f + self.t1)
        if self.memory_model == "paper":
            mem_ok = e * self.Mem_ps[None] <= self.mem
        else:
            mem_ok = e * self.Mem_act[None] + self.Mem_static[None] <= self.mem
        ok = self.tri[None] & mem_ok
        seg_cost = torch.where(ok, fp + bp, inf)
        seg_beta = torch.where(ok, torch.maximum(fp, bp), inf)

        # comms: (I1, N, N) over [i, n, m]
        fb = (eff[None, :] * self.fb1)[:, :, None]   # bytes fwd at cut i
        gb = (eff[None, :] * self.gb1)[:, :, None]   # bytes bwd at cut i
        zero = torch.zeros((), dtype=_F64, device=self.device)
        tf = torch.where(fb == 0.0, zero,
                         torch.where(self.rate > 0, fb / self.rate, inf))
        tb = torch.where(gb == 0.0, zero,
                         torch.where(self.rate_T > 0, gb / self.rate_T, inf))
        comm_cost = tf + tb
        comm_beta = torch.maximum(tf, tb)
        comm_cost[0] = np.inf                       # no cut before layer 1
        comm_beta[0] = np.inf
        idx = torch.arange(self.N, device=self.device)
        comm_cost[:, idx, idx] = np.inf             # no self-transfer
        comm_beta[:, idx, idx] = np.inf

        return MSPGraph(profile=self.profile, net=self.net, b=b,
                        seg_cost=seg_cost, seg_beta=seg_beta,
                        comm_cost=comm_cost, comm_beta=comm_beta,
                        src_cost=seg_cost[0, 0, :].clone(),
                        src_beta=seg_beta[0, 0, :].clone())


def build_graph(profile: ModelProfile, net: EdgeNetwork, b: int,
                memory_model: str = "paper", device="cuda") -> MSPGraph:
    """One-shot graph build (delegates to :class:`GraphFactory`)."""
    return GraphFactory(profile, net, memory_model, device).graph(b)


def graph_stats(g: MSPGraph) -> dict:
    """Vertex/edge counts of the *paper's* explicit graph (Eqs. 20-21),
    for complexity reporting (Theorem 3)."""
    I, N = g.I, g.N
    vertices = sum(i for i in range(1, I + 1)) * N  # ranges x nodes
    finite = int(torch.isfinite(g.seg_cost).sum())
    return {"paper_vertices": vertices, "paper_edges_upper": finite * (N - 1),
            "state_edges": finite}


def path_to_solution(path: list) -> SplitSolution:
    """Convert [(node, end_layer), ...] (client first) into a SplitSolution."""
    cuts = tuple(end for _, end in path)
    placement = tuple(node for node, _ in path)
    return SplitSolution(cuts=cuts, placement=placement)
