"""Edge-network model: heterogeneous nodes + wireless/wired links (Sec. III).

The port's copy of ``repro/core/network.py``, with the reference's TPU
stage network mapped onto H100s (:func:`stage_network`).  Nodes carry ``(f_n, kappa_n, M_n, p_n, t0, t1, b_th)``; links
carry ``(W_nn', d_nn')`` and yield the Shannon rate of Eq. (4):

    r_nn' = W_nn' * log2(1 + p_n * d_nn'^{-gamma} / N0)

with ``N0 = n0_density * W_nn'``.  Traffic between nodes that are not
directly connected is forwarded along the topology's shortest path: the
effective rate is 1 / sum_hops(1/r_hop).  Host-side numpy, bit-equal to the
reference for the same seed.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Sequence

import numpy as np

# NVIDIA H100 SXM5 constants (the reference's TPU_* ones are a v5e chip's).
#: bf16 dense on the tensor cores, FLOP/s (H100 data sheet, SXM5, no sparsity)
H100_PEAK_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s (H100 data sheet, SXM5)
H100_HBM_BW = 3.35e12
#: HBM3 capacity, bytes (H100 data sheet, SXM5: 80 GB)
H100_HBM_BYTES = 80e9
#: NVLink 4 per GPU and direction, bytes/s: 900 GB/s both ways (H100 data
#: sheet), inside one NVSwitch domain of 8 GPUs (a DGX / HGX H100 node)
H100_NVLINK_BW = 450e9
#: NDR InfiniBand between nodes, bytes/s per GPU: one 400 Gb/s ConnectX-7
#: port a GPU (DGX H100 user guide), 400e9 / 8
H100_IB_BW = 50e9


@dataclasses.dataclass(frozen=True)
class Node:
    """One compute node (client or edge server). Units per Table I/II."""
    name: str
    f: float                 # computing capability (FLOP/s)
    kappa: float = 1.0       # computing intensity (FLOPs per workload unit)
    mem: float = 8 * 2**30   # M_n: max accelerator memory (bytes)
    p: float = 0.3           # transmit power (W)
    t0: float = 1e-3         # FP init/model-load coefficient (t0^c / t0^s)
    t1: float = 1e-3         # BP constant-latency coefficient (t1^c / t1^s)
    b_th: int = 32           # BP latency threshold (b_th^c / b_th^s)
    is_client: bool = False


@dataclasses.dataclass
class EdgeNetwork:
    """N servers + one virtual client tier, with an effective rate matrix.

    ``nodes[0]`` is always the *virtual client node* (the M clients grouped
    as in Eq. (20)).  ``rate[n, n']`` is the effective bytes/s between
    nodes, after multi-hop forwarding over the physical topology.
    """
    nodes: list
    rate: np.ndarray          # (|N|, |N|) effective bytes/s
    num_clients: int = 1      # M
    topology: str = "mesh"

    def __post_init__(self):
        n = len(self.nodes)
        if self.rate.shape != (n, n):
            raise ValueError("rate matrix shape mismatch")

    @property
    def client(self) -> Node:
        return self.nodes[0]

    @property
    def servers(self) -> list:
        return self.nodes[1:]

    @property
    def num_servers(self) -> int:
        return len(self.nodes) - 1

    def server_indices(self) -> range:
        return range(1, len(self.nodes))

    def degraded(self, failed: Sequence[int]) -> "EdgeNetwork":
        """Return a copy with the given *server* indices removed (node
        loss): the surviving nodes keep their order, so every index after a
        failed one shifts down."""
        failed = set(failed)
        if 0 in failed:
            raise ValueError("cannot fail the client tier")
        keep = [i for i in range(len(self.nodes)) if i not in failed]
        return EdgeNetwork(
            nodes=[self.nodes[i] for i in keep],
            rate=self.rate[np.ix_(keep, keep)].copy(),
            num_clients=self.num_clients,
            topology=self.topology,
        )

    def with_fluctuation(self, rng: np.random.Generator,
                         cv: float) -> "EdgeNetwork":
        """Gaussian multiplicative noise with coefficient-of-variation ``cv``
        on rates and compute capabilities (Fig. 6's fluctuation model), drawn
        from ``rng`` in the reference's order: the rate matrix, then each
        node's speed."""
        if cv <= 0:
            return self
        noise = np.maximum(rng.normal(1.0, cv, self.rate.shape), 0.05)
        rate = self.rate * noise
        nodes = [dataclasses.replace(
            n, f=n.f * max(float(rng.normal(1.0, cv)), 0.05))
            for n in self.nodes]
        return EdgeNetwork(nodes=nodes, rate=rate,
                           num_clients=self.num_clients,
                           topology=self.topology)


def shannon_rate(bandwidth_hz: float, power_w: float, distance_m: float,
                 gamma: float = 3.5, n0_dbm_hz: float = -174.0) -> float:
    """Eq. (4): achievable rate in *bytes/s* over a wireless link."""
    n0 = 10 ** (n0_dbm_hz / 10.0) * 1e-3 * bandwidth_hz  # noise power (W)
    snr = power_w * distance_m ** (-gamma) / n0
    bits = bandwidth_hz * math.log2(1.0 + snr)
    return bits / 8.0


def _adjacency(topology: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """Boolean adjacency among n physical nodes (node 0 = client tier)."""
    adj = np.zeros((n, n), dtype=bool)
    if topology == "mesh":
        adj[:] = True
    elif topology == "line":
        for i in range(n - 1):
            adj[i, i + 1] = adj[i + 1, i] = True
    elif topology == "star":
        hub = 1 if n > 1 else 0        # first server is the hub
        adj[hub, :] = adj[:, hub] = True
    elif topology == "tree":           # binary tree rooted at the client
        for i in range(1, n):
            parent = (i - 1) // 2
            adj[i, parent] = adj[parent, i] = True
    elif topology == "random_geometric":
        pos = rng.uniform(0, 500.0, (n, 2))
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        adj = d < 300.0
        for i in range(n - 1):         # ensure connectivity
            adj[i, i + 1] = adj[i + 1, i] = True
    else:
        raise ValueError(f"unknown topology {topology!r}")
    np.fill_diagonal(adj, False)
    return adj


def _effective_rates(link_rate: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """Per-pair effective bytes/s with store-and-forward over shortest
    per-byte-time paths (Dijkstra on cost = 1/r per hop)."""
    n = link_rate.shape[0]
    inv = np.where(adj & (link_rate > 0), 1.0 / np.maximum(link_rate, 1e-30), np.inf)
    eff = np.zeros((n, n))
    for s in range(n):
        dist = np.full(n, np.inf)
        dist[s] = 0.0
        pq = [(0.0, s)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u]:
                continue
            for v in range(n):
                nd = d + inv[u, v]
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(pq, (nd, v))
        with np.errstate(divide="ignore"):
            eff[s] = np.where(dist > 0, 1.0 / dist, 0.0)
    np.fill_diagonal(eff, 0.0)
    return eff


def make_edge_network(
    num_servers: int = 6,
    num_clients: int = 4,
    topology: str = "mesh",
    *,
    seed: int = 0,
    f_range: tuple = (1e12, 10e12),          # 1-10 TFLOPS (Table II)
    bw_range_hz: tuple = (10e6, 50e6),       # sub-6GHz low-speed case
    mem_range: tuple = (2 * 2**30, 16 * 2**30),
    power_range_w: tuple = (0.1, 0.5),
    area_m: float = 500.0,
    gamma: float = 3.5,
    kappa: float = 1.0,
    client_f: float = 13.5e9,                # Raspberry-Pi-class client tier
    client_mem: float = 4 * 2**30,
    t0: float = 1e-3, t1: float = 1e-3, b_th: int = 32,
) -> EdgeNetwork:
    """Sample a paper-style edge network (Sec. VI simulation setup)."""
    rng = np.random.default_rng(seed)
    n = num_servers + 1  # + virtual client node
    nodes = [Node(name="clients", f=client_f, kappa=kappa, mem=client_mem,
                  p=float(rng.uniform(*power_range_w)), t0=t0, t1=t1,
                  b_th=b_th, is_client=True)]
    for s in range(num_servers):
        nodes.append(Node(
            name=f"server{s}", f=float(rng.uniform(*f_range)), kappa=kappa,
            mem=float(rng.uniform(*mem_range)),
            p=float(rng.uniform(*power_range_w)), t0=t0, t1=t1, b_th=b_th))
    pos = rng.uniform(0, area_m, (n, 2))
    dist = np.maximum(np.linalg.norm(pos[:, None] - pos[None, :], axis=-1), 1.0)
    link = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            w = float(rng.uniform(*bw_range_hz))
            link[i, j] = shannon_rate(w, nodes[i].p, dist[i, j], gamma)
    adj = _adjacency(topology, n, rng)
    rate = _effective_rates(link, adj)
    return EdgeNetwork(nodes=nodes, rate=rate, num_clients=num_clients,
                       topology=topology)


def stage_network(num_stages: int, gpus_per_stage: int, *,
                  peak_flops: float = H100_PEAK_FLOPS,
                  hbm_bytes: float = H100_HBM_BYTES,
                  link_bw: float = H100_IB_BW,
                  links_per_hop: int = 1) -> EdgeNetwork:
    """The paper's network mapped onto a pipeline of GPU stage groups — the
    counterpart of the reference's ``tpu_stage_network``, with H100
    defaults.

    A line of ``num_stages`` homogeneous stage groups, each aggregating
    ``gpus_per_stage`` GPUs (data-parallel within the group, so per-sample
    throughput scales with the group).  Node 0 doubles as the "client
    tier" = stage 0 (the embedding holder); there is no wireless channel:
    the link rate is ``link_bw`` times the parallel links between groups.

    The default link is NDR InfiniBand (50 GB/s a GPU): a stage group of a
    production pipeline usually fills one or more 8-GPU nodes, so
    neighbouring stages talk across nodes; pass ``link_bw=H100_NVLINK_BW``
    for stages inside one NVSwitch domain.  Given the reference's TPU
    constants (``peak_flops=197e12, hbm_bytes=16 * 2**30, link_bw=50e9``)
    it builds the reference's network, field for field."""
    nodes = [Node(name="stage0", f=peak_flops * gpus_per_stage, kappa=1.0,
                  mem=hbm_bytes * gpus_per_stage, t0=0.0, t1=0.0,
                  b_th=0, is_client=True)]
    for s in range(1, num_stages):
        nodes.append(Node(name=f"stage{s}", f=peak_flops * gpus_per_stage,
                          kappa=1.0, mem=hbm_bytes * gpus_per_stage,
                          t0=0.0, t1=0.0, b_th=0))
    link = np.zeros((num_stages, num_stages))
    for i in range(num_stages - 1):
        link[i, i + 1] = link[i + 1, i] = link_bw * links_per_hop
    adj = _adjacency("line", num_stages, np.random.default_rng(0))
    rate = _effective_rates(link, adj)
    return EdgeNetwork(nodes=nodes, rate=rate, num_clients=1, topology="line")
