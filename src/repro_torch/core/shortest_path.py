"""Algorithm 1 — bottleneck-aware shortest path for the MSP problem.

The port of ``repro/core/shortest_path.py``.  The MSP objective (P4) is
min over paths of  T_f(path) + xi(b) * T_1(path),  T_1 = the path's
bottleneck.  dist(t) — the min-sum value restricted to edges with
beta <= t — is a non-increasing step function that only changes at the
distinct bottleneck values, and  OPT = min over t of dist(t) + xi * t.

``solver="batched"`` (the default):
  1. one sweep at t = inf  ->  dist(inf) and the unrestricted path
  2. one *min-max* sweep   ->  beta* = the smallest feasible threshold
  3. ONE masked min-plus sweep over the admissible window
     [beta*, (UB - dist(inf)) / xi] returns dist(t) for every candidate
  4. argmin over dist(t) + xi * t, one reconstruction sweep at the winner

``solver="scan"`` (the reference's legacy control flow): binary search of
the smallest feasible threshold, then an ascending pruned scan, one dense
sweep per threshold.

The DP tensors live on the planner's device in float64.  Every sweep that
needs no parents — the min-max sweep of step 2 and the window sweep of
step 3 — goes through the hand-written min-plus kernel K1
(``repro_torch.kernels.minplus.sweep_minplus``; its plain PyTorch version
on the CPU).  Sweeps that track parents (steps 1 and 4) are plain torch on
the device.  Every operation is ``+``, ``max``, ``min`` or a compare and
every argmin takes the *first* minimum, so the planner returns bit for bit
the reference numpy planner's result on either device.

Restricted DPs (the fixed-cut / fixed-placement masks of the RC+OP and
RP+OC baselines), ``solve_many``, ``update`` and the jax backend are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..kernels.minplus import sweep_minplus
from . import latency as L
from .latency import SplitSolution
from .msp_graph import GraphFactory, MSPGraph
from .network import EdgeNetwork
from .profiles import ModelProfile

#: default Algorithm-1 solver; "scan" is the legacy reference implementation
DEFAULT_SOLVER = "batched"

_INF = math.inf


@dataclasses.dataclass
class MSPResult:
    solution: SplitSolution
    objective: float        # T_f + xi * T1  as searched (paper objective)
    T_f: float              # min-sum part of the searched objective
    T_1: float              # bottleneck of the chosen path (searched beta)
    L_t: float              # true Eq. (14) latency of the solution
    T_i_true: float         # true Eq. (13) interval (with co-location sums)
    b: int
    B: int
    thresholds_scanned: int = 0   # every DP sweep of the solve
    feasible: bool = True
    solver: str = ""


# ---------------------------------------------------------------------------
# The parent-tracking layered-DP sweep
# ---------------------------------------------------------------------------

class _SweepResult:
    __slots__ = ("best_val", "best_k", "best_m", "parents")

    def __init__(self, best_val, best_k, best_m, parents):
        self.best_val, self.best_k, self.best_m = best_val, best_k, best_m
        self.parents = parents


def _sweep(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts) -> _SweepResult:
    """Threshold-batched (+, min) layered-DP sweep with parent tracking.

    Tensor layouts (no leading slice axis: one graph, ``S = len(ts)``
    thresholds):

      Ccom/Bcom[n, i, m]  comm cost / bottleneck crossing cut i, n -> m
      Sseg/Bseg[i, m, j]  segment (i, j] on node m
      src_cost/src_beta[i]  client segment (0, i]

    Per layer:  A[s, i, m] = min over n of dist[s, n, i] + Ccom[n, i, m],
    then  dist'[s, m, j] = min over i of A[s, i, m] + Sseg[i, m, j], over
    edges with beta <= ts[s].  Ties break to the smallest n and then the
    smallest i (the first minimum), as the reference's ``np.argmin`` does.
    Results come back to the host: ``best_*`` as numpy arrays and the
    per-layer parents as a list of ``(Ap, Sp)`` numpy pairs.
    """
    S = ts.shape[0]
    N, I1 = Ccom.shape[0], Ccom.shape[1]
    I = I1 - 1
    inf = torch.tensor(_INF, dtype=Ccom.dtype, device=Ccom.device)

    dist = torch.full((S, N, I1), _INF, dtype=Ccom.dtype, device=Ccom.device)
    dist[:, 0, :] = torch.where(src_beta <= ts[:, None], src_cost, inf)
    fin0 = torch.isfinite(dist[:, 0, I])
    best_val = torch.where(fin0, dist[:, 0, I], inf)
    best_k = fin0.long()
    best_m = torch.zeros(S, dtype=torch.long, device=Ccom.device)
    Aps, Sps = [], []

    t4 = ts[:, None, None, None]
    Vc = torch.where(Bcom <= t4, Ccom, inf)
    Vs = torch.where(Bseg <= t4, Sseg, inf)
    for k in range(2, K + 1):
        # stage 1: communication hop (n, i) -> node m across cut i
        A, Ap = torch.min(dist[:, :, :, None] + Vc, dim=1)      # (S, I1, N)
        # stage 2: extend with segment (i, j] on node m
        nd, Sp = torch.min(A[:, :, :, None] + Vs, dim=1)        # (S, N, I1)
        Aps.append(Ap)
        Sps.append(Sp)
        dist = nd
        if N > 1:
            v, arg = torch.min(nd[:, 1:, I], dim=1)
            upd = v < best_val
            if upd.any():
                best_val = torch.where(upd, v, best_val)
                best_k = torch.where(upd, k, best_k)
                best_m = torch.where(upd, arg + 1, best_m)
        if not torch.isfinite(nd).any():
            break
    parents = []
    if Aps:
        Ap_all = torch.stack(Aps).cpu().numpy()
        Sp_all = torch.stack(Sps).cpu().numpy()
        parents = list(zip(Ap_all, Sp_all))
    return _SweepResult(best_val.cpu().numpy(), best_k.cpu().numpy(),
                        best_m.cpu().numpy(), parents)


def _walk_parents(parents, s: int, k: int, m: int, j: int) -> list:
    """Reconstruct the [(node, end_layer), ...] path for slice ``s``."""
    if k == 1:
        return [(0, j)]
    path = [(int(m), int(j))]
    for kk in range(k, 1, -1):
        Ap, Sp = parents[kk - 2]
        i = int(Sp[s, m, j])
        n = int(Ap[s, i, m])
        path.append((n, i))
        m, j = n, i
    path.reverse()
    return path


def _betas_from_arrays(Bcom, Bseg, src_beta, lo=-_INF, hi=_INF) -> list:
    """Finite candidate bottleneck values max(Bcom, Bseg) within [lo, hi].

    ``max(a, b)`` is always one of its arguments, so the distinct edge-beta
    value set is exactly

        {Bcom[n,i,m]  : Bcom[n,i,m] >= min_j Bseg[i,m,j]}  |
        {Bseg[i,m,j]  : Bseg[i,m,j] >= min_n Bcom[n,i,m]}

    — computed in O(N I N + I N I) without the dense O(N^2 I^2) max."""
    def in_window(x):
        return (x >= lo) & (x <= hi) & torch.isfinite(x)

    min_seg = Bseg.amin(dim=2)                       # (I1, N) over (i, m)
    min_com = Bcom.amin(dim=0)                       # (I1, N) over (i, m)
    return [src_beta[in_window(src_beta)],
            Bcom[in_window(Bcom) & (Bcom >= min_seg[None])],
            Bseg[in_window(Bseg) & (Bseg >= min_com[:, :, None])]]


class _LayeredDP:
    """Two-stage DP over one MSPGraph, rebindable to a new micro-batch's
    graph.  Its tensors are the graph's, on the graph's device."""

    def __init__(self, g: MSPGraph, K: int):
        self.K = K
        self.rebind(g)

    def rebind(self, g: MSPGraph) -> "_LayeredDP":
        self.g = g
        self.N, self.I = g.N, g.I
        idx = torch.arange(self.N, device=g.comm_cost.device)
        # comm-stage tensors over (n, i, m); destinations must be servers
        Ccom = g.comm_cost.permute(1, 0, 2).contiguous()
        Bcom = g.comm_beta.permute(1, 0, 2).contiguous()
        Ccom[:, :, 0] = _INF
        Bcom[:, :, 0] = _INF
        Ccom[idx, :, idx] = _INF                     # n' != n (Eq. 21)
        Bcom[idx, :, idx] = _INF
        self._Ccom, self._Bcom = Ccom, Bcom
        # seg-stage tensors over (i, m, j)
        self._Sseg = g.seg_cost.permute(1, 0, 2).contiguous()
        self._Bseg = g.seg_beta.permute(1, 0, 2).contiguous()
        src_ok = torch.isfinite(g.src_cost)
        self._src_cost = torch.where(src_ok, g.src_cost, _INF)
        self._src_beta = torch.where(src_ok, g.src_beta, _INF)
        self._dense_beta = None          # legacy dense edge betas, on demand
        return self

    def _kernel_args(self):
        return (self._Ccom, self._Bcom, self._Sseg, self._Bseg,
                self._src_cost, self._src_beta, self.K)

    def _ts(self, ts) -> torch.Tensor:
        return torch.as_tensor(ts, dtype=self._Ccom.dtype,
                               device=self._Ccom.device).reshape(-1)

    # -- sweeps --------------------------------------------------------------
    def sweep(self, ts) -> _SweepResult:
        """Parent-tracking sweep at every threshold in ``ts``."""
        return _sweep(*self._kernel_args(), self._ts(ts))

    def run(self, t: float):
        """Shortest path with all edge betas <= t. Returns (dist, path)."""
        out = self.sweep([t])
        if out.best_k[0] == 0:
            return math.inf, None
        path = _walk_parents(out.parents, 0, int(out.best_k[0]),
                             int(out.best_m[0]), self.I)
        return float(out.best_val[0]), path

    def run_dense(self, t: float):
        """Legacy reference sweep: materializes the dense (i, n, m, j) edge
        tensor per layer — the Algorithm-1 inner loop ``solver="scan"``
        keeps as the cross-validation baseline.

        Bit-identical to :meth:`run`: the edge weight is grouped as
        ``(dist + comm) + seg`` and the argmin flattens (i, n)-major, which
        reproduces the two-stage kernel's float rounding and tie-breaking."""
        N, I = self.N, self.I
        I1 = I + 1
        dev = self._Ccom.device
        inf = torch.tensor(_INF, dtype=self._Ccom.dtype, device=dev)
        Ccom_inm = self._Ccom.permute(1, 0, 2)           # (I1, N, N)
        Sseg = self._Sseg                                # (I1, N, I1)
        if self._dense_beta is None:
            self._dense_beta = torch.maximum(
                self._Bcom.permute(1, 0, 2)[:, :, :, None],
                self._Bseg[:, None, :, :])
        dist = torch.full((N, I1), _INF, dtype=self._Ccom.dtype, device=dev)
        dist[0, :] = torch.where(self._src_beta <= t, self._src_cost, inf)
        best_val, best_state = _INF, None
        d0 = float(dist[0, I])
        if math.isfinite(d0):
            best_val, best_state = d0, (1, 0, I)
        parents = []
        ok = self._dense_beta <= t
        for k in range(2, self.K + 1):
            tmp = dist.T[:, :, None] + Ccom_inm          # (I1, N, N) [i,n,m]
            cand = tmp[:, :, :, None] + Sseg[:, None, :, :]   # (I1,N,N,I1)
            cand = torch.where(ok, cand, inf)
            nd, arg = torch.min(cand.reshape(I1 * N, N, I1), dim=0)
            parents.append(arg)                          # encodes i * N + n
            dist = nd
            if N > 1:
                v, am = torch.min(nd[1:, I], dim=0)
                if float(v) < best_val:
                    best_val = float(v)
                    best_state = (k, 1 + int(am), I)
            if not torch.isfinite(nd).any():
                break
        if best_state is None:
            return math.inf, None
        k, m, j = best_state
        parents = [p.cpu().numpy() for p in parents[:k - 1]]
        path = [(m, j)]
        while k >= 2:
            p = int(parents[k - 2][m, j])
            i, n = divmod(p, N)
            path.append((n, i))
            m, j, k = n, i, k - 1
        path.reverse()
        return best_val, path

    def dist_at(self, ts) -> torch.Tensor:
        """dist(t) for every threshold in ``ts`` — one launch of K1."""
        return sweep_minplus(*self._kernel_args(), self._ts(ts))

    def min_bottleneck(self) -> float:
        """beta* = min over feasible paths of the path bottleneck: K1 in
        (max, min) mode at the single threshold inf."""
        out = sweep_minplus(*self._kernel_args(), self._ts([_INF]),
                            mode="max")
        return float(out[0])

    # -- candidate thresholds ------------------------------------------------
    def betas_window(self, lo: float, hi: float) -> torch.Tensor:
        """Sorted distinct candidate bottleneck values within [lo, hi]."""
        vals = _betas_from_arrays(self._Bcom, self._Bseg, self._src_beta,
                                  lo, hi)
        return torch.unique(torch.cat(vals), sorted=True)

    def all_betas(self) -> torch.Tensor:
        return self.betas_window(-_INF, _INF)


# ---------------------------------------------------------------------------
# The reusable planner: factory + DP caches + both solver strategies
# ---------------------------------------------------------------------------

class Planner:
    """Reusable Algorithm-1 engine for one (profile, network, memory model)
    on one device (``"cuda"`` unless the caller passes ``device="cpu"``).

    Holds the :class:`~repro_torch.core.msp_graph.GraphFactory` plus the DP
    buffers, so repeated solves — BCD iterations, multi-start restarts —
    share all structural work, and memoizes solve results.
    """

    def __init__(self, profile: ModelProfile, net: EdgeNetwork,
                 memory_model: str = "paper", device="cuda"):
        self.profile, self.net = profile, net
        self.memory_model = memory_model
        self.device = resolve_device(device)
        self.factory = GraphFactory(profile, net, memory_model, self.device)
        self._graphs: dict = {}
        self._dps: dict = {}
        self._solved: dict = {}

    # -- caches -------------------------------------------------------------
    def graph(self, b: int) -> MSPGraph:
        g = self._graphs.get(b)
        if g is None:
            obs.inc("planner.graph_cache_miss")
            g = self.factory.graph(b)
            self._graphs[b] = g
        else:
            obs.inc("planner.graph_cache_hit")
        return g

    def _dp(self, b: int, K: int) -> _LayeredDP:
        g = self.graph(b)
        dp = self._dps.get(K)
        if dp is None:
            obs.inc("planner.dp_cache_miss")
            dp = _LayeredDP(g, K)
            self._dps[K] = dp
        else:
            obs.inc("planner.dp_cache_hit")
            if dp.g is not g:
                dp.rebind(g)
        return dp

    def default_K(self, K: int | None) -> int:
        if K is not None:
            return K
        return min(1 + self.net.num_servers, self.profile.num_layers)

    # -- result assembly ----------------------------------------------------
    def _finish(self, g: MSPGraph, dist, path, b, B, xi, sweeps, solver):
        profile, net = self.profile, self.net
        if path is None:
            return MSPResult(solution=SplitSolution((profile.num_layers,), (0,)),
                             objective=math.inf, T_f=math.inf, T_1=math.inf,
                             L_t=math.inf, T_i_true=math.inf, b=b, B=B,
                             thresholds_scanned=sweeps, feasible=False,
                             solver=solver)
        sol = SplitSolution(cuts=tuple(i for _, i in path),
                            placement=tuple(n for n, _ in path))
        T_f = L.fill_latency(profile, net, sol, b)
        T_i = L.pipeline_interval(profile, net, sol, b)
        beta_path = _path_bottleneck(g, path)
        return MSPResult(solution=sol, objective=dist + xi * beta_path,
                         T_f=T_f, T_1=beta_path, L_t=T_f + xi * T_i,
                         T_i_true=T_i, b=b, B=B, thresholds_scanned=sweeps,
                         solver=solver)

    # -- solvers ------------------------------------------------------------
    def solve(self, b: int, B: int, K: int | None = None,
              solver: str | None = None) -> MSPResult:
        solver = solver or DEFAULT_SOLVER
        K = self.default_K(K)
        # Algorithm-1 solves are deterministic in these arguments, and the
        # BCD alternation re-requests the same (b, B) repeatedly
        key = (b, B, K, solver)
        hit = self._solved.get(key)
        if hit is not None:
            obs.inc("planner.solve_memo_hit")
            return hit
        obs.inc("planner.solve_memo_miss")
        with obs.span("planner.solve", b=b, B=B, solver=solver):
            dp = self._dp(b, K)
            g = self.graph(b)
            xi = L.num_fills(B, b)
            if solver == "scan":
                res = self._solve_scan(dp, g, b, B, xi)
            elif solver == "batched":
                res = self._solve_batched(dp, g, b, B, xi)
            else:
                raise ValueError(
                    f"unknown solver {solver!r} (want 'scan'|'batched')")
        obs.inc("planner.dp_sweeps", res.thresholds_scanned)
        self._solved[key] = res
        return res

    def _solve_scan(self, dp: _LayeredDP, g: MSPGraph, b, B, xi) -> MSPResult:
        """Legacy Algorithm 1: binary search + ascending pruned scan, one
        dense-tensor DP sweep per probed threshold."""
        sweeps = 0

        def run(t):
            nonlocal sweeps
            sweeps += 1
            return dp.run_dense(t)

        if xi == 0:                            # no pipelining: pure min-sum
            dist, path = run(math.inf)
            return self._finish(g, dist, path, b, B, xi, sweeps, "scan")

        betas = dp.all_betas().cpu().numpy()
        if betas.size == 0:
            return self._finish(g, math.inf, None, b, B, xi, sweeps, "scan")
        dist_full, path_full = run(math.inf)
        if path_full is None:
            return self._finish(g, math.inf, None, b, B, xi, sweeps, "scan")

        # binary search the smallest feasible threshold (monotone in t)
        lo, hi = 0, len(betas) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            d, _ = run(float(betas[mid]))
            if math.isfinite(d):
                hi = mid
            else:
                lo = mid + 1

        best, best_pair = math.inf, None
        for idx in range(lo, len(betas)):
            t = float(betas[idx])
            if dist_full + xi * t >= best:      # admissible prune -> break
                break
            d, p = run(t)
            if p is None:
                continue
            beta_p = _path_bottleneck(g, p)     # actual path bottleneck <= t
            obj = d + xi * beta_p
            if obj < best:
                best, best_pair = obj, (d, p)
        if best_pair is None:
            return self._finish(g, math.inf, None, b, B, xi, sweeps, "scan")
        return self._finish(g, best_pair[0], best_pair[1], b, B, xi, sweeps,
                            "scan")

    def _solve_batched(self, dp: _LayeredDP, g: MSPGraph, b, B,
                       xi) -> MSPResult:
        """Threshold-batched Algorithm 1 (see module docstring)."""
        dist_full, path_full = dp.run(math.inf)
        sweeps = 1
        if xi == 0:
            return self._finish(g, dist_full, path_full, b, B, xi, sweeps,
                                "batched")
        if path_full is None:
            return self._finish(g, math.inf, None, b, B, xi, sweeps, "batched")

        beta_star = dp.min_bottleneck()        # smallest feasible threshold
        sweeps += 1
        d_star, p_star = dp.run(beta_star)
        sweeps += 1
        ub = min(dist_full + xi * _path_bottleneck(g, path_full),
                 d_star + xi * _path_bottleneck(g, p_star))
        cap = (ub - dist_full) / xi            # prune: dist_full + xi*t >= ub
        window = dp.betas_window(beta_star, cap * (1 + 1e-12) + 1e-12)
        if window.numel() == 0:                # numerical corner: fall back
            window = dp._ts([beta_star])
        dvals = dp.dist_at(window)
        sweeps += 1
        j = int(torch.argmin(dvals + xi * window))   # first minimum
        t_hat = float(window[j])
        if t_hat == beta_star:
            d_hat, p_hat = d_star, p_star
        else:
            d_hat, p_hat = dp.run(t_hat)
            sweeps += 1
        return self._finish(g, d_hat, p_hat, b, B, xi, sweeps, "batched")


def solve_msp(profile: ModelProfile, net: EdgeNetwork, b: int, B: int,
              K: int | None = None, memory_model: str = "paper",
              solver: str | None = None, planner: Planner | None = None,
              device="cuda") -> MSPResult:
    """Algorithm 1.  Returns the optimal (x, y) for fixed micro-batch b.

    Pass a :class:`Planner` to amortize the graph factory and DP buffers
    across calls (it must have been built for the same memory model)."""
    if planner is not None and planner.memory_model != memory_model:
        raise ValueError(
            f"planner was built with memory_model={planner.memory_model!r} "
            f"but solve_msp was called with {memory_model!r}")
    pl = planner if planner is not None else Planner(profile, net,
                                                     memory_model, device)
    return pl.solve(b, B, K=K, solver=solver)


def _path_edges(g: MSPGraph, path: list):
    """Gather index tensors of a path's edges (prev node/cut -> node/cut)."""
    dev = g.comm_cost.device
    prev, cur = path[:-1], path[1:]
    i = torch.tensor([p[1] for p in prev], device=dev, dtype=torch.long)
    n = torch.tensor([p[0] for p in prev], device=dev, dtype=torch.long)
    m = torch.tensor([c[0] for c in cur], device=dev, dtype=torch.long)
    j = torch.tensor([c[1] for c in cur], device=dev, dtype=torch.long)
    return i, n, m, j


def _path_bottleneck(g: MSPGraph, path: list) -> float:
    """Max component (paper-mode T_1) along a reconstructed path (one
    gather and one device-to-host copy)."""
    i, n, m, j = _path_edges(g, path)
    edges = torch.maximum(g.comm_beta[i, n, m], g.seg_beta[m, i, j])
    beta = float(g.src_beta[path[0][1]])
    for e in edges.tolist():
        beta = max(beta, e)
    return beta


# ---------------------------------------------------------------------------
# Brute-force verifiers (tests)
# ---------------------------------------------------------------------------

def enumerate_solutions(profile: ModelProfile, net: EdgeNetwork, K: int):
    """Yield every feasible-shaped SplitSolution (cuts + placement)."""
    I = profile.num_layers
    servers = list(net.server_indices())
    for s in range(1, K + 1):                 # number of non-empty segments
        for cuts in itertools.combinations(range(1, I), s - 1):
            cuts = cuts + (I,)
            if s == 1:
                yield SplitSolution(cuts=cuts, placement=(0,))
                continue
            for placing in itertools.product(servers, repeat=s - 1):
                placement = (0,) + placing
                if any(placement[a] == placement[a + 1] for a in range(s - 1)):
                    continue
                yield SplitSolution(cuts=cuts, placement=placement)


def brute_force_msp(profile: ModelProfile, net: EdgeNetwork, b: int, B: int,
                    K: int, objective: str = "paper",
                    memory_model: str = "paper", device="cuda"):
    """Exhaustive MSP search.  ``objective='paper'`` replicates Algorithm 1's
    per-segment semantics (for optimality tests); ``'true'`` evaluates the
    full Eq. (13)/(14) with co-location sums and joint memory (C8)."""
    xi = L.num_fills(B, b)
    if objective == "paper":
        g = GraphFactory(profile, net, memory_model, device).graph(b)
        # one host copy of the graph: the search reads it edge by edge
        host = {name: getattr(g, name).cpu().numpy()
                for name in ("comm_cost", "comm_beta", "seg_cost",
                             "seg_beta", "src_cost", "src_beta")}
    best, best_sol = math.inf, None
    for sol in enumerate_solutions(profile, net, K):
        if objective == "paper":
            path = list(zip(sol.placement, sol.cuts))
            ok = np.isfinite(host["src_cost"][path[0][1]])
            prev = path[0]
            cost = float(host["src_cost"][path[0][1]])
            beta = float(host["src_beta"][path[0][1]])
            for (n, i) in path[1:]:
                c = float(host["comm_cost"][prev[1], prev[0], n]
                          + host["seg_cost"][n, prev[1], i])
                if not math.isfinite(c):
                    ok = False
                    break
                cost += c
                beta = max(beta, float(max(host["comm_beta"][prev[1], prev[0], n],
                                           host["seg_beta"][n, prev[1], i])))
                prev = (n, i)
            if not ok:
                continue
            val = cost + xi * beta
        else:
            if not L.memory_feasible(profile, net, sol, b, memory_model):
                continue
            val = L.total_latency(profile, net, sol, b, B)
        if val < best:
            best, best_sol = val, sol
    return best, best_sol
