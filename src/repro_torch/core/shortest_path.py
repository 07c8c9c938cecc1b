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

Restrictions (the fixed cuts of RC+OP, the fixed placement of RP+OC) are
per-layer masks (``_LayeredDP._masks``).  K1 folds one mask per threshold,
the same for every layer, so a restricted DP's parent-free sweeps run the
masked plain sweep on the planner's device instead, as the reference keeps
them off its Pallas kernel; each is counted as ``planner.masked_sweeps``.

``Planner.solve_many`` solves a whole micro-batch sweep at once (the
b-sweep of ``exhaustive_joint``): the graphs of every b are stacked on a
leading axis, and each phase is one sweep over all b — the full-graph and
reconstruction sweeps in plain torch, the min-max sweep and the
(b, threshold) window sweep as one K1 launch each (``graph=``).

Backends (``solve`` / ``solve_many``'s ``backend=``): ``"exact"`` (the
default; the above, float64 throughout — the reference's ``"numpy"`` and
``"pallas"``) and ``"device"`` (the reference's ``"jax"``): the batched
device planner of :mod:`~repro_torch.core.planner_device`, which assembles
the graphs from the factory's basis tensors in ``dtype`` (float32 by
default, or float64, then bit-identical to ``"exact"``) and sweeps every
(b, threshold) slice of a phase in one K1 launch.

Warm replans: ``Planner.update(delta)`` applies a rate change or a
straggler to the cached graphs in place (bitwise equal to a fresh
assembly) and keeps each solved (b, B, K)'s hint — its path and lower
bounds of dist(inf) and beta*, scaled by how far any edge can have shrunk.
The next ``solve`` then runs ``_solve_warm``: the hinted path repriced
gives an upper bound, and one window sweep between the bounds (plain torch
keeping each layer's dist for up to 32 thresholds, else one K1 launch and
one single-threshold stack sweep) plus a backtrace from the dist stack
return the cold solve's result bit for bit.  A node failure or a snapshot
rebuilds everything.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np
import torch

from .. import obs
from .._device import resolve_device
from ..kernels.minplus import sweep_minplus
from ..kernels.minplus.ref import slices_per_chunk
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
    __slots__ = ("best_val", "best_k", "best_m", "parents", "stack")

    def __init__(self, best_val, best_k, best_m, parents, stack=None):
        self.best_val, self.best_k, self.best_m = best_val, best_k, best_m
        self.parents = parents
        self.stack = stack          # per-layer dist tensors (want_stack)


def _sweep(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, *,
           mode="sum", masks=None, want_parents=True,
           want_stack=False) -> _SweepResult:
    """Threshold-batched layered-DP sweep over the (k, n, i) DAG.

    Tensor layouts (a leading slice axis of size 1 broadcasts, size S runs
    S independent instances — thresholds and/or per-b graphs):

      Ccom/Bcom[s, n, i, m]  comm cost / bottleneck crossing cut i, n -> m
      Sseg/Bseg[s, i, m, j]  segment (i, j] on node m
      src_cost/src_beta[s, i]  client segment (0, i]

    ``mode="sum"`` relaxes with (+, min) among edges with beta <= ts[s];
    ``mode="max"`` with (max, min), the minimal path bottleneck.  Per
    layer:  A[s, i, m] = min over n of dist[s, n, i] (+|max) Ccom[s, n, i,
    m], then  dist'[s, m, j] = min over i of A[s, i, m] (+|max) Sseg[s, i,
    m, j].  ``masks(k)`` gives layer k's restriction masks over (n, i, m)
    and (i, m, j) (either may be None); masked candidates are set to inf
    *after* the op, as the reference does.  Ties break to the smallest n
    and then the smallest i (the first minimum), as the reference's
    ``np.argmin`` does.  ``best_*`` stay on the device; with
    ``want_parents`` the per-layer parents come back to the host as a list
    of ``(Ap, Sp)`` numpy pairs.  ``want_stack`` keeps every layer's
    ``dist`` on the device (``stack[k - 2]`` = dist after layer k, shape
    (S, N, I+1)), so a path is rebuilt afterwards by
    ``planner_device.backtrace_stack`` without tracking parents — the
    warm-replan and device-backend reconstruction path.
    """
    S = ts.shape[0]
    N, I1 = Ccom.shape[1], Ccom.shape[2]
    I = I1 - 1
    dev = Ccom.device
    inf = torch.tensor(_INF, dtype=Ccom.dtype, device=dev)
    is_sum = mode == "sum"
    op = torch.add if is_sum else torch.maximum

    dist = torch.full((S, N, I1), _INF, dtype=Ccom.dtype, device=dev)
    dist[:, 0, :] = torch.where(src_beta <= ts[:, None],
                                src_cost if is_sum else src_beta, inf)
    fin0 = torch.isfinite(dist[:, 0, I])
    best_val = torch.where(fin0, dist[:, 0, I], inf)
    best_k = fin0.long()
    best_m = torch.zeros(S, dtype=torch.long, device=dev)
    Aps, Sps = [], []
    stack = [] if want_stack else None

    # the threshold mask is layer-independent: fold beta > t edges to inf
    t4 = ts[:, None, None, None]
    Vc = torch.where(Bcom <= t4, Ccom if is_sum else Bcom, inf)
    Vs = torch.where(Bseg <= t4, Sseg if is_sum else Bseg, inf)
    for k in range(2, K + 1):
        mc, ms = masks(k) if masks is not None else (None, None)
        # stage 1: communication hop (n, i) -> node m across cut i
        cand_c = op(dist[:, :, :, None], Vc)                 # (S, N, I1, N)
        if mc is not None:
            cand_c.masked_fill_(~mc, _INF)
        if want_parents:
            A, Ap = torch.min(cand_c, dim=1)                 # (S, I1, N)
            Aps.append(Ap)
        else:
            A = cand_c.amin(dim=1)
        # stage 2: extend with segment (i, j] on node m
        cand_s = op(A[:, :, :, None], Vs)                    # (S, I1, N, I1)
        if ms is not None:
            cand_s.masked_fill_(~ms, _INF)
        if want_parents:
            nd, Sp = torch.min(cand_s, dim=1)                # (S, N, I1)
            Sps.append(Sp)
        else:
            nd = cand_s.amin(dim=1)
        dist = nd
        if want_stack:
            stack.append(nd)
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
    return _SweepResult(best_val, best_k, best_m, parents, stack)


def stack_column(stack: list, s: int) -> np.ndarray:
    """Slice ``s`` of a ``want_stack`` sweep's per-layer dist tensors as one
    host array (layers, N, I+1): a single device-to-host copy."""
    return torch.stack([layer[s] for layer in stack]).cpu().numpy()


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


def _betas_from_arrays(Bcom, Bseg, src_beta, lo=-_INF, hi=_INF,
                       mask_c=None, mask_s=None) -> list:
    """Finite candidate bottleneck values max(Bcom, Bseg) within [lo, hi].

    Unmasked, ``max(a, b)`` is always one of its arguments, so the distinct
    edge-beta value set is exactly

        {Bcom[n,i,m]  : Bcom[n,i,m] >= min_j Bseg[i,m,j]}  |
        {Bseg[i,m,j]  : Bseg[i,m,j] >= min_n Bcom[n,i,m]}

    — computed in O(N I N + I N I) without the dense O(N^2 I^2) max.
    Masked (restricted) calls take the dense max over (n, i, m, j) in
    chunks of source nodes, as the reference does."""
    def in_window(x):
        return (x >= lo) & (x <= hi) & torch.isfinite(x)

    vals = [src_beta[in_window(src_beta)]]
    if mask_c is None and mask_s is None:
        min_seg = Bseg.amin(dim=2)                   # (I1, N) over (i, m)
        min_com = Bcom.amin(dim=0)                   # (I1, N) over (i, m)
        return vals + [Bcom[in_window(Bcom) & (Bcom >= min_seg[None])],
                       Bseg[in_window(Bseg) & (Bseg >= min_com[:, :, None])]]
    N = Bcom.shape[0]
    chunk = max(1, int(2 ** 22 // max(1, Bseg.numel())))
    for n0 in range(0, N, chunk):
        dense = torch.maximum(Bcom[n0:n0 + chunk, :, :, None], Bseg[None])
        if mask_c is not None:
            dense = dense.masked_fill(~mask_c[n0:n0 + chunk, :, :, None],
                                      _INF)
        if mask_s is not None:
            dense = dense.masked_fill(~mask_s[None], _INF)
        vals.append(dense[in_window(dense)])
    return vals


class _LayeredDP:
    """Two-stage DP over one MSPGraph, rebindable to a new micro-batch's
    graph.  Its tensors are the graph's, on the graph's device.

    ``restrict_cuts`` / ``restrict_placement`` fix the path's cut layers or
    its nodes (the RC+OP and RP+OC baselines); they become per-layer masks
    (``_masks``), built once on the device and kept across rebinds.
    """

    def __init__(self, g: MSPGraph, K: int,
                 restrict_cuts: Sequence[int] | None = None,
                 restrict_placement: Sequence[int] | None = None):
        self.K = K
        self.restrict_cuts = tuple(restrict_cuts) if restrict_cuts else None
        self.restrict_placement = (tuple(restrict_placement)
                                   if restrict_placement else None)
        self._mask_cache: dict = {}
        self.rebind(g)

    @property
    def restricted(self) -> bool:
        return (self.restrict_cuts is not None or
                self.restrict_placement is not None)

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
        if self.restrict_cuts is not None:
            sel = torch.zeros_like(src_ok)
            sel[self.restrict_cuts[0]] = True
            src_ok = src_ok & sel
        self._src_cost = torch.where(src_ok, g.src_cost, _INF)
        self._src_beta = torch.where(src_ok, g.src_beta, _INF)
        self._dense_beta = None          # legacy dense edge betas, on demand
        self._mirror = None              # host copy for backtraces, on demand
        return self

    # -- restriction masks ---------------------------------------------------
    def _masks(self, k: int):
        """(comm mask over (n, i, m), seg mask over (i, m, j)) for layer k,
        either None where that side is unrestricted."""
        got = self._mask_cache.get(k)
        if got is not None:
            return got
        I1, N = self.I + 1, self.N
        dev = self._Ccom.device
        mc = ms = None
        if self.restrict_cuts is not None:
            prev, cur = self.restrict_cuts[k - 2], self.restrict_cuts[k - 1]
            mc = torch.zeros((N, I1, N), dtype=torch.bool, device=dev)
            mc[:, prev, :] = True
            ms = torch.zeros((I1, N, I1), dtype=torch.bool, device=dev)
            ms[prev, :, cur] = True
        if self.restrict_placement is not None:
            pn = self.restrict_placement[k - 2]
            cn = self.restrict_placement[k - 1]
            mc2 = torch.zeros((N, I1, N), dtype=torch.bool, device=dev)
            mc2[pn, :, cn] = True
            mc = mc2 if mc is None else (mc & mc2)
            ms2 = torch.zeros((I1, N, I1), dtype=torch.bool, device=dev)
            ms2[:, cn, :] = True
            ms = ms2 if ms is None else (ms & ms2)
        self._mask_cache[k] = (mc, ms)
        return mc, ms

    def _kernel_args(self):
        return (self._Ccom, self._Bcom, self._Sseg, self._Bseg,
                self._src_cost, self._src_beta, self.K)

    def _ts(self, ts) -> torch.Tensor:
        return torch.as_tensor(ts, dtype=self._Ccom.dtype,
                               device=self._Ccom.device).reshape(-1)

    # -- sweeps --------------------------------------------------------------
    def sweep(self, ts, *, mode="sum", want_parents=True,
              want_stack=False) -> _SweepResult:
        """Plain-torch sweep at every threshold in ``ts``, masked when the
        DP is restricted; with parents unless ``want_parents`` is False,
        with the per-layer dist stack if ``want_stack``."""
        return _sweep(*(x[None] for x in self._kernel_args()[:6]), self.K,
                      self._ts(ts), mode=mode,
                      masks=self._masks if self.restricted else None,
                      want_parents=want_parents, want_stack=want_stack)

    def mirror(self) -> tuple:
        """The bound float64 graph tensors in backtrace layout
        (``planner_device.backtrace_stack``) as host numpy arrays, copied
        once per bind."""
        if self._mirror is None:
            self._mirror = tuple(x.cpu().numpy()
                                 for x in self._kernel_args()[:6])
        return self._mirror

    def run(self, t: float):
        """Shortest path with all edge betas <= t. Returns (dist, path)."""
        out = self.sweep([t])
        best_k = int(out.best_k[0])
        if best_k == 0:
            return math.inf, None
        path = _walk_parents(out.parents, 0, best_k, int(out.best_m[0]),
                             self.I)
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
        for k in range(2, self.K + 1):
            tmp = dist.T[:, :, None] + Ccom_inm          # (I1, N, N) [i,n,m]
            cand = tmp[:, :, :, None] + Sseg[:, None, :, :]   # (I1,N,N,I1)
            ok = self._dense_beta <= t
            if self.restricted:
                mc, msk = self._masks(k)
                if mc is not None:
                    ok = ok & mc.permute(1, 0, 2)[:, :, :, None]
                if msk is not None:
                    ok = ok & msk[:, None, :, :]
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
        """dist(t) for every threshold in ``ts``: one launch of K1, or for a
        restricted DP the masked plain sweep, in slice chunks that bound its
        candidate tensors (chunking changes no value)."""
        ts = self._ts(ts)
        if not self.restricted:
            return sweep_minplus(*self._kernel_args(), ts)
        obs.inc("planner.masked_sweeps")
        per = slices_per_chunk(self.N, self.I + 1)
        return torch.cat([self.sweep(ts[c0:c0 + per],
                                     want_parents=False).best_val
                          for c0 in range(0, ts.shape[0], per)])

    def min_bottleneck(self) -> float:
        """beta* = min over feasible paths of the path bottleneck: K1 in
        (max, min) mode at the single threshold inf (the masked plain sweep
        for a restricted DP)."""
        if not self.restricted:
            out = sweep_minplus(*self._kernel_args(), self._ts([_INF]),
                                mode="max")
            return float(out[0])
        obs.inc("planner.masked_sweeps")
        out = self.sweep([_INF], mode="max", want_parents=False)
        return float(out.best_val[0])

    # -- candidate thresholds ------------------------------------------------
    def betas_window(self, lo: float, hi: float) -> torch.Tensor:
        """Sorted distinct candidate bottleneck values within [lo, hi]."""
        if not self.restricted:
            vals = _betas_from_arrays(self._Bcom, self._Bseg, self._src_beta,
                                      lo, hi)
        else:
            src = self._src_beta
            vals = [src[(src >= lo) & (src <= hi) & torch.isfinite(src)]]
            for k in range(2, self.K + 1):
                mc, msk = self._masks(k)
                vals += _betas_from_arrays(self._Bcom, self._Bseg,
                                           self._src_beta, lo, hi,
                                           mask_c=mc, mask_s=msk)[1:]
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
    buffers, so repeated solves — BCD iterations, multi-start restarts,
    replans after :meth:`update` — share all structural work, and memoizes
    solve results.  ``backend`` picks how the parent-free sweeps run:
    ``"exact"`` (float64 through K1, the default) or ``"device"`` (the
    batched device planner of :mod:`~repro_torch.core.planner_device`, in
    ``dtype``).
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
        self._epoch = 0                 # bumped by every update()
        self._device_dps: dict = {}     # (K, dtype) -> DeviceDP
        self._mirrors: dict = {}        # (b, dtype) -> host-mirror arrays
        self._hints: dict = {}          # (b, B, K) -> warm-start hint

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

    def _dp(self, b: int, K: int, rc=None, rp=None) -> _LayeredDP:
        key = (K, rc, rp)
        g = self.graph(b)
        dp = self._dps.get(key)
        if dp is None:
            obs.inc("planner.dp_cache_miss")
            dp = _LayeredDP(g, K, rc, rp)
            self._dps[key] = dp
        else:
            obs.inc("planner.dp_cache_hit")
            if dp.g is not g:
                dp.rebind(g)
        return dp

    def default_K(self, K: int | None) -> int:
        if K is not None:
            return K
        return min(1 + self.net.num_servers, self.profile.num_layers)

    def _device_dp(self, K: int, dtype):
        """The device backend's state for this factory (cached)."""
        from .planner_device import DeviceDP
        ddp = self._device_dps.get((K, dtype))
        if ddp is None:
            ddp = DeviceDP(self.factory, K, dtype)
            self._device_dps[(K, dtype)] = ddp
        return ddp

    def _device_mirrors(self, bs: list, ddp) -> list:
        """Host mirrors of the graphs the device backend ``ddp`` assembles
        for every b in ``bs`` (cached; the missing ones in one call)."""
        dt = ddp.dtype
        missing = sorted({b for b in bs if (b, dt) not in self._mirrors})
        if missing:
            effs = np.stack([self.factory.effective_batch(b)
                             for b in missing])
            for b, m in zip(missing, ddp.mirrors(effs)):
                self._mirrors[(b, dt)] = m
        return [self._mirrors[(b, dt)] for b in bs]

    # -- incremental updates ------------------------------------------------
    def update(self, delta) -> "Planner":
        """Apply a single-resource delta *in place* and invalidate exactly
        what it touched — the warm-replan entry point.

        ``delta`` is duck-typed against the ``ft`` events (the port's or the
        reference's):

          - ``RateChange``-like (``n_from``/``n_to``/``factor``): the rate
            mutation is replayed float op for float op, the factory's rate
            tensors are swapped, and each cached graph's comm columns for
            the (n_from, n_to) **pair** (both directions use the link) are
            re-assembled by ``GraphFactory.comm_pair`` — bitwise equal to a
            fresh assembly on the mutated network.
          - ``Straggler``-like (``node``/``slowdown``): the node-speed
            mutation, patching that node's seg rows (``seg_node``) and, for
            the client tier, the source vectors.
          - ``NodeFailure``-like (``server``): renumbering — everything is
            rebuilt on ``net.degraded([server])`` (shapes change).
          - ``Resync``-like (``net``): full rebuild on the snapshot.

        A patched graph is a new ``MSPGraph`` object sharing the patched
        tensors, so a cached DP sees ``dp.g is not g`` and rebinds.  Warm
        hints survive a patch with their lower bounds scaled by ``r_min`` —
        the largest factor by which any edge weight may have *shrunk* (1 /
        factor for a rate increase, the slowdown for a node speed-up, 1
        otherwise) — so they still bound the new ``dist(inf)`` and
        ``beta*`` from below and the next ``solve`` runs one windowed sweep
        instead of a cold Algorithm 1 (``_solve_warm``).  Returns ``self``.
        """
        if hasattr(delta, "server"):                      # NodeFailure
            obs.inc("planner.updates[rebuild]")
            self._rebuild(self.net.degraded([delta.server]))
            return self
        if hasattr(delta, "factor"):                      # RateChange
            obs.inc("planner.updates[rate]")
            rate = self.net.rate.copy()
            rate[delta.n_from, delta.n_to] *= delta.factor
            self.net = dataclasses.replace(self.net, rate=rate)
            self.factory.patch_rate(self.net)
            u, v = int(delta.n_from), int(delta.n_to)
            for b, g in list(self._graphs.items()):
                eff = self.factory.effective_batch(b)
                for (a, c) in {(u, v), (v, u)}:
                    cost, beta = self.factory.comm_pair(eff, a, c)
                    g.comm_cost[:, a, c] = cost
                    g.comm_beta[:, a, c] = beta
                self._graphs[b] = dataclasses.replace(g, net=self.net)
            r_min = min(1.0, 1.0 / delta.factor) if delta.factor > 0 else 0.0
            self._after_patch(r_min)
            return self
        if hasattr(delta, "slowdown"):                    # Straggler
            obs.inc("planner.updates[speed]")
            w = int(delta.node)
            self.net = dataclasses.replace(
                self.net,
                nodes=[dataclasses.replace(n, f=n.f / delta.slowdown)
                       if i == w else n
                       for i, n in enumerate(self.net.nodes)])
            self.factory.patch_node_speed(self.net)
            for b, g in list(self._graphs.items()):
                eff = self.factory.effective_batch(b)
                sc, sb = self.factory.seg_node(eff, w)
                g.seg_cost[w] = sc
                g.seg_beta[w] = sb
                kw = {"net": self.net}
                if w == 0:
                    kw["src_cost"] = sc[0].clone()
                    kw["src_beta"] = sb[0].clone()
                self._graphs[b] = dataclasses.replace(g, **kw)
            r_min = min(1.0, float(delta.slowdown))
            self._after_patch(r_min)
            return self
        if getattr(delta, "net", None) is not None:       # Resync snapshot
            obs.inc("planner.updates[rebuild]")
            self._rebuild(delta.net)
            return self
        raise TypeError(f"unsupported planner delta: {delta!r}")

    def _after_patch(self, r_min: float) -> None:
        """Invalidate what an in-place patch touched: solve memos, host
        mirrors and the device backends' copies of rate / f.  Hints survive
        with their lower bounds scaled by ``r_min``."""
        self._epoch += 1
        self._solved.clear()
        self._mirrors.clear()
        for ddp in self._device_dps.values():
            ddp.refresh()
        for h in self._hints.values():
            h["lb_dist"] *= r_min
            h["lb_beta"] *= r_min

    def _rebuild(self, net: EdgeNetwork) -> None:
        """Full invalidation (renumbering / snapshot): a new factory, every
        cache dropped; hints die with the old node indices."""
        self._epoch += 1
        self.net = net
        self.factory = GraphFactory(self.profile, net, self.memory_model,
                                    self.device)
        self._graphs.clear()
        self._dps.clear()
        self._solved.clear()
        self._mirrors.clear()
        self._device_dps.clear()
        self._hints.clear()

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
              restrict_cuts: Sequence[int] | None = None,
              restrict_placement: Sequence[int] | None = None,
              solver: str | None = None, backend: str = "exact",
              dtype=torch.float32) -> MSPResult:
        """One Algorithm-1 call.  ``backend="device"`` sweeps the threshold
        window in ``dtype`` on graphs the device backend assembles (float32
        by default); every other sweep, the result and its objective stay
        float64."""
        solver = solver or DEFAULT_SOLVER
        _check_backend(backend, dtype)
        K = self.default_K(K)
        rc = tuple(restrict_cuts) if restrict_cuts else None
        rp = tuple(restrict_placement) if restrict_placement else None
        # Algorithm-1 solves are deterministic in these arguments, and the
        # BCD alternation re-requests the same (b, B) repeatedly
        key = (b, B, K, rc, rp, solver, backend,
               dtype if backend == "device" else None)
        hit = self._solved.get(key)
        if hit is not None:
            obs.inc("planner.solve_memo_hit")
            return hit
        obs.inc("planner.solve_memo_miss")
        with obs.span("planner.solve", b=b, B=B, solver=solver):
            dp = self._dp(b, K, rc, rp)
            g = self.graph(b)
            xi = L.num_fills(B, b)
            if solver == "scan":
                res = self._solve_scan(dp, g, b, B, xi)
            elif solver == "batched":
                res = None
                hint = (self._hints.get((b, B, K))
                        if rc is None and rp is None and backend == "exact"
                        else None)
                if hint is not None and xi > 0:
                    res = self._solve_warm(dp, g, b, B, xi, hint)
                if res is not None:
                    obs.inc("planner.incremental_hits")
                else:
                    if rc is None and rp is None:
                        obs.inc("planner.cold_solves")
                    res = self._solve_batched(dp, g, b, B, xi, backend,
                                              dtype)
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

    def _solve_batched(self, dp: _LayeredDP, g: MSPGraph, b, B, xi,
                       backend="exact", dtype=torch.float32) -> MSPResult:
        """Threshold-batched Algorithm 1 (see module docstring).  An
        unrestricted exact solve leaves a warm-start hint for ``update``."""
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
        dvals = self._dist_window(dp, window, backend, dtype)
        sweeps += 1
        j = int(torch.argmin(dvals + xi * window))   # first minimum
        t_hat = float(window[j])
        if t_hat == beta_star:
            d_hat, p_hat = d_star, p_star
        else:
            d_hat, p_hat = dp.run(t_hat)
            sweeps += 1
        if backend == "exact" and not dp.restricted and p_hat is not None:
            self._hints[(b, B, dp.K)] = {"lb_dist": dist_full,
                                         "lb_beta": beta_star,
                                         "path": list(p_hat)}
        return self._finish(g, d_hat, p_hat, b, B, xi, sweeps, "batched")

    def _dist_window(self, dp: _LayeredDP, window, backend: str,
                     dtype) -> torch.Tensor:
        """The window sweep, by backend: ``"exact"`` is ``dp.dist_at`` (one
        float64 K1 launch); ``"device"`` is ``planner_device.
        dist_at_device`` (one K1 launch on the device backend's graph in
        ``dtype``).  A restricted DP runs the masked plain sweep under
        either (``planner.masked_sweeps``), as the reference keeps it on
        numpy under every backend."""
        if backend == "device":
            from .planner_device import dist_at_device
            return dist_at_device(dp, window, self, dtype)
        return dp.dist_at(window)

    def _solve_warm(self, dp: _LayeredDP, g: MSPGraph, b, B, xi,
                    hint: dict):
        """Warm-started Algorithm 1 from a surviving hint — bit-identical to
        the cold batched solve, in a fraction of its sweeps.

        The hint carries a known-valid path (the previous optimum, repriced
        here on the patched graph -> upper bound UB) and scaled lower bounds
        ``lb_dist <= dist(inf)`` and ``lb_beta <= beta*``.  Every global
        minimizer t of dist(t) + xi*t then lies in
        ``[lb_beta, (UB - lb_dist) / xi]``: t >= beta* >= lb_beta, and
        xi*t = OPT - dist(t) <= UB - dist(inf) <= UB - lb_dist.  The cold
        solver's window is pruned by the same argument with its own bounds,
        so both windows contain every global minimizer, the first-minimum
        argmin lands on the same smallest minimizing threshold, and the
        path rebuilt there is the cold solve's, with the same floats.

        A window of at most 32 thresholds is swept once, in plain torch,
        keeping each layer's dist; a larger one goes through K1
        (``dp.dist_at``) and then one single-threshold stack sweep at the
        winner.  The path is rebuilt from the stack by
        ``planner_device.backtrace_stack``.  Returns None (the caller
        solves cold) when the hinted path went infeasible or a numerical
        corner empties the window."""
        from .planner_device import backtrace_stack, reprice_dp_order

        cost, beta_p = reprice_dp_order(g, hint["path"])
        if not (math.isfinite(cost) and math.isfinite(beta_p)):
            return None
        ub = cost + xi * beta_p
        cap = (ub - hint["lb_dist"]) / xi
        window = dp.betas_window(hint["lb_beta"], cap * (1 + 1e-12) + 1e-12)
        if window.numel() == 0:
            return None
        fused = window.numel() <= 32
        if fused:
            out = dp.sweep(window, want_parents=False, want_stack=True)
            dvals = out.best_val
        else:
            dvals = dp.dist_at(window)
        j = int(torch.argmin(dvals + xi * window))   # first minimum
        t_hat = float(window[j])
        if not math.isfinite(float(dvals[j])):
            return None
        if not fused:
            out = dp.sweep([t_hat], want_parents=False, want_stack=True)
            j = 0
        best_k = int(out.best_k[j])
        if best_k == 0:
            return None
        path = backtrace_stack(stack_column(out.stack, j), dp.mirror(),
                               t_hat, best_k, int(out.best_m[j]), dp.I)
        self._hints[(b, B, dp.K)]["path"] = list(path)
        return self._finish(g, float(out.best_val[j]), path, b, B, xi,
                            1 if fused else 2, "batched")

    # -- batched micro-batch sweep (exhaustive_joint's inner loop) ----------
    def solve_many(self, bs: Sequence[int], B: int, K: int | None = None,
                   backend: str = "exact", dtype=torch.float32) -> list:
        """Algorithm 1 for every micro-batch size in ``bs`` at once.

        ``backend="exact"``: the graphs of every b are stacked on a leading
        axis, and each phase runs once for all b — the full-graph runs, the
        beta* probes and the reconstructions as stacked parent-tracking
        sweeps, the min-max beta* sweep and the sweep over every
        (b, threshold) window pair as one K1 launch each.  Results are
        bit-identical to ``[self.solve(b, B, K, solver="batched") for b in
        bs]``.  ``backend="device"`` runs
        :func:`~repro_torch.core.planner_device.solve_many_device` in
        ``dtype`` (bit-identical in float64; float32 within the reference's
        float32 contract)."""
        _check_backend(backend, dtype)
        bs = list(bs)
        with obs.span("planner.solve_many", n=len(bs), B=B, backend=backend):
            if backend == "device":
                from .planner_device import solve_many_device
                results = solve_many_device(self, bs, B, K, dtype)
            else:
                results = self._solve_many(bs, B, K)
        obs.inc("planner.dp_sweeps",
                sum(r.thresholds_scanned for r in results))
        return results

    def _solve_many(self, bs: list, B: int, K: int | None = None) -> list:
        K = self.default_K(K)
        S = len(bs)
        I = self.profile.num_layers
        graphs = [self.graph(b) for b in bs]
        # the stacked graphs, with the structural infs of ``rebind``
        Ccom = torch.stack([g.comm_cost.permute(1, 0, 2) for g in graphs])
        Bcom = torch.stack([g.comm_beta.permute(1, 0, 2) for g in graphs])
        Sseg = torch.stack([g.seg_cost.permute(1, 0, 2) for g in graphs])
        Bseg = torch.stack([g.seg_beta.permute(1, 0, 2) for g in graphs])
        src_cost = torch.stack([g.src_cost for g in graphs])
        src_beta = torch.stack([g.src_beta for g in graphs])
        idx = torch.arange(Ccom.shape[1], device=self.device)
        for V in (Ccom, Bcom):
            V[:, :, :, 0] = _INF
            V[:, idx, :, idx] = _INF
        stack = (Ccom, Bcom, Sseg, Bseg, src_cost, src_beta)
        xi = [L.num_fills(B, b) for b in bs]

        def ts_of(values):
            return torch.as_tensor(values, dtype=Ccom.dtype,
                                   device=self.device).reshape(-1)

        def stacked(sel, ts, **kw):
            """Parent-tracking sweep of the selected graphs at ts."""
            sel = torch.as_tensor(sel, device=self.device)
            return _sweep(*(x[sel] for x in stack), K, ts_of(ts), **kw)

        # phase A: full-graph runs for every b (one stacked sweep)
        outA = _sweep(*stack, K, ts_of([_INF] * S))
        valA, kA, mA = (outA.best_val.tolist(), outA.best_k.tolist(),
                        outA.best_m.tolist())
        paths_full = [_walk_parents(outA.parents, s, kA[s], mA[s], I)
                      if kA[s] else None for s in range(S)]

        results: list = [None] * S
        live = []                               # slices still being solved
        for s in range(S):
            if xi[s] == 0 or paths_full[s] is None:
                results[s] = self._finish(graphs[s], valA[s], paths_full[s],
                                          bs[s], B, xi[s], 1, "batched")
            else:
                live.append(s)
        if not live:
            return results

        # phase B: one K1 launch of (max, min) sweeps -> beta* per live b,
        # then one stacked probe at beta* (parents -> the upper-bound path)
        beta_star = sweep_minplus(*stack, K, ts_of([_INF] * len(live)),
                                  mode="max", graph=live).tolist()
        outP = stacked(live, beta_star)
        valP, kP, mP = (outP.best_val.tolist(), outP.best_k.tolist(),
                        outP.best_m.tolist())
        paths_star, windows = [], []
        for q, s in enumerate(live):
            p_star = _walk_parents(outP.parents, q, kP[q], mP[q], I)
            paths_star.append(p_star)
            ub = min(valA[s] + xi[s] * _path_bottleneck(graphs[s],
                                                        paths_full[s]),
                     valP[q] + xi[s] * _path_bottleneck(graphs[s], p_star))
            cap = (ub - valA[s]) / xi[s]
            w = _betas_from_arrays(Bcom[s], Bseg[s], src_beta[s],
                                   beta_star[q], cap * (1 + 1e-12) + 1e-12)
            w = torch.unique(torch.cat(w), sorted=True)
            if w.numel() == 0:
                w = ts_of([beta_star[q]])
            windows.append(w)

        # phase C: ONE K1 launch over every (b, threshold) pair, then the
        # argmin per b (first minimum: the smallest t)
        slice_b = [s for s, w in zip(live, windows) for _ in range(w.numel())]
        dvals = sweep_minplus(*stack, K, torch.cat(windows), graph=slice_b)
        t_hat, pos = [], 0
        for q, w in enumerate(windows):
            H = dvals[pos:pos + w.numel()] + xi[live[q]] * w
            t_hat.append(float(w[int(torch.argmin(H))]))
            pos += w.numel()

        # phase D: one stacked reconstruction sweep at the winners; slices
        # whose winner IS beta* reuse the phase-B probe path (same sweep,
        # same threshold), as the per-b solve does — which also keeps the
        # 4-vs-5 sweep accounting identical to solve()
        need = [q for q in range(len(live)) if t_hat[q] != beta_star[q]]
        if need:
            outR = stacked([live[q] for q in need], [t_hat[q] for q in need])
            valR, kR, mR = (outR.best_val.tolist(), outR.best_k.tolist(),
                            outR.best_m.tolist())
        for r, q in enumerate(need):
            s = live[q]
            path = (_walk_parents(outR.parents, r, kR[r], mR[r], I)
                    if kR[r] else None)
            results[s] = self._finish(graphs[s], valR[r], path, bs[s], B,
                                      xi[s], 5, "batched")
        for q, s in enumerate(live):
            if results[s] is None:                  # t_hat == beta*
                results[s] = self._finish(graphs[s], valP[q], paths_star[q],
                                          bs[s], B, xi[s], 4, "batched")
        return results


BACKENDS = ("exact", "device")


def _check_backend(backend: str, dtype) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of "
                         f"{BACKENDS})")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"not {dtype}")


def solve_msp(profile: ModelProfile, net: EdgeNetwork, b: int, B: int,
              K: int | None = None, memory_model: str = "paper",
              restrict_cuts: Sequence[int] | None = None,
              restrict_placement: Sequence[int] | None = None,
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
    return pl.solve(b, B, K=K, restrict_cuts=restrict_cuts,
                    restrict_placement=restrict_placement, solver=solver)


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


def path_cost(g: MSPGraph, path: list) -> float:
    """Sum of the edge weights along [(node, end_layer), ...], client
    first: the client segment's cost plus every edge after it."""
    (n0, i0) = path[0]
    c = float(g.src_cost[i0])
    prev_n, prev_i = n0, i0
    for (n, i) in path[1:]:
        c += g.edge_cost(prev_n, prev_i, n, i)
        prev_n, prev_i = n, i
    return c


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
