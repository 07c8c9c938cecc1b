"""The batched device planner: Algorithm 1 over many (b, threshold) slices.

The port's counterpart of ``src/repro/core/planner_jax.py`` (renamed: the
port never imports jax).  ``Planner.solve_many(..., backend="device")``
runs :func:`solve_many_device`, ``Planner.solve(..., backend="device")``
sweeps its threshold window through :func:`dist_at_device`, and
``exhaustive_joint(..., backend="device")`` reaches the first.

:class:`DeviceDP` keeps the factory's b-independent basis tensors (workload
tables, rates, node constants) on the planner's device in the chosen dtype
and assembles one graph per distinct micro-batch size from them, with the
reference's elementwise op chain (separate torch ops, in its order: no
fused or contracted arithmetic) and ``rebind``'s structural folds.  Its
sweeps take a slice axis of (b, threshold) pairs:

  - without a stack (phase B's min-max sweep at t = inf, phase C's sweep
    of every (b, t) window pair, ``dist_at_device``): ONE launch of the
    hand-written min-plus kernel K1, the assembled graphs stacked and each
    slice naming its graph (``sweep_minplus(..., graph=)``);
  - with a stack (phases A, P and D): the plain-torch sweep on the stacked
    graphs, keeping each layer's dist, from which :func:`backtrace_stack`
    rebuilds each slice's path on the host against a host mirror of the
    same assembled graph — no parent tracking on the device.

Numerics: in float64 every value equals the exact backend's bit for bit,
so the results do too.  In float32 the reference's float32 contract holds
(``tests/test_planner_jax.py``): feasibility equal, the float64-repriced
objective within rtol 1e-4 (:func:`parity_tolerance`), ``b`` equal.
Results are repriced in float64 on the planner's own graph
(:func:`reprice_dp_order`), so a float32-chosen path reports exact numbers.

The reference pads the slice count to buckets of 8-128 to bound the number
of compiled variants; K1 takes any count, so nothing is padded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs
from ..kernels.minplus import sweep_minplus
from . import latency as L
from .shortest_path import _betas_from_arrays, _sweep

_INF = math.inf


def parity_tolerance(dtype) -> float:
    """Relative tolerance of the device backend against the exact one:
    0.0 in float64 (bit for bit), 1e-4 in float32 (about K accumulated
    roundings through the DP plus the argmin's near ties)."""
    if dtype == torch.float64:
        return 0.0
    if dtype == torch.float32:
        return 1e-4
    raise ValueError(f"the device backend runs float32 or float64, not "
                     f"{dtype}")


# ---------------------------------------------------------------------------
# Device state: basis tensors in the backend's dtype, per-b graph assembly
# ---------------------------------------------------------------------------

class DeviceDP:
    """The device backend over one ``GraphFactory`` (the counterpart of the
    reference's ``JaxDP``): its basis tensors in ``dtype`` on the factory's
    device, the graph assembly and the batched sweeps.  ``refresh`` re-reads
    what ``Planner.update`` patches in place (rates, node speeds)."""

    def __init__(self, factory, K: int, dtype):
        self.factory, self.K, self.dtype = factory, K, dtype
        self.N = factory.N
        self.device = factory.device
        self.paper_memory = factory.memory_model == "paper"

        def cast(x):
            return x.to(dtype)

        self.kappa, self.t0, self.t1 = (cast(factory.kappa),
                                        cast(factory.t0), cast(factory.t1))
        self.b_th, self.mem = cast(factory.b_th), cast(factory.mem)
        self.W_fp, self.W_bp = cast(factory.W_fp), cast(factory.W_bp)
        self.Mem_ps, self.Mem_act = cast(factory.Mem_ps), cast(
            factory.Mem_act)
        self.Mem_static = cast(factory.Mem_static)
        self.tri = factory.tri
        self.fb1, self.gb1 = cast(factory.fb1), cast(factory.gb1)
        self._inf = torch.tensor(_INF, dtype=dtype, device=self.device)
        self._zero = torch.zeros((), dtype=dtype, device=self.device)
        self.refresh()

    def refresh(self) -> None:
        """Re-read the update-mutable basis tensors after a patch."""
        fac = self.factory
        self.rate = fac.rate.to(self.dtype)                  # (1, N, N)
        self.rate_T = fac.rate_T.to(self.dtype)
        self.rate_pos = fac.rate > 0                         # float64 test
        self.rate_T_pos = fac.rate_T > 0
        self.f = fac.f.to(self.dtype)                        # (N, 1, 1)

    def assemble(self, effs) -> tuple:
        """The graphs of G effective-batch vectors ``effs`` (G, N), in the
        DP layout with a leading graph axis: ``(Ccom, Bcom)`` (G, N, I+1,
        N), ``(Sseg, Bseg)`` (G, I+1, N, I+1), ``(src_cost, src_beta)``
        (G, I+1), structural infs folded in."""
        inf, zero = self._inf, self._zero
        eff = torch.as_tensor(np.asarray(effs, dtype=np.float64),
                              device=self.device).to(self.dtype)   # (G, N)
        e = eff[:, :, None, None]                          # (G, N, 1, 1)
        a1 = e * self.kappa
        a2 = torch.clamp_min(e - self.b_th, 0.0) * self.kappa
        fp = (a1 * self.W_fp) / self.f + self.t0           # (G, N, I1, I1)
        bpw = a2 * self.W_bp
        bp = torch.where(bpw == 0.0, self.t1, bpw / self.f + self.t1)
        if self.paper_memory:
            mok = e * self.Mem_ps <= self.mem
        else:
            mok = e * self.Mem_act + self.Mem_static <= self.mem
        ok = self.tri & mok
        seg_cost = torch.where(ok, fp + bp, inf)           # (G, n, i, j)
        seg_beta = torch.where(ok, torch.maximum(fp, bp), inf)

        fb = (eff[:, None, :] * self.fb1)[..., None]       # (G, I1, N, 1)
        gb = (eff[:, None, :] * self.gb1)[..., None]
        tf = torch.where(fb == 0.0, zero,
                         torch.where(self.rate_pos, fb / self.rate, inf))
        tb = torch.where(gb == 0.0, zero,
                         torch.where(self.rate_T_pos, gb / self.rate_T, inf))
        idx = torch.arange(self.N, device=self.device)
        Ccom = (tf + tb).permute(0, 2, 1, 3).contiguous()  # (G, n, i, m)
        Bcom = torch.maximum(tf, tb).permute(0, 2, 1, 3).contiguous()
        for V in (Ccom, Bcom):
            V[:, :, 0, :] = _INF              # no cut before layer 1
            V[:, :, :, 0] = _INF              # destinations are servers
            V[:, idx, :, idx] = _INF          # n' != n (Eq. 21)
        return (Ccom, Bcom,
                seg_cost.permute(0, 2, 1, 3).contiguous(),   # (G, i, m, j)
                seg_beta.permute(0, 2, 1, 3).contiguous(),
                seg_cost[:, 0, 0, :].contiguous(),
                seg_beta[:, 0, 0, :].contiguous())

    def mirrors(self, effs) -> list:
        """Host copies of :meth:`assemble`'s graphs, one tuple of numpy
        arrays per row of ``effs`` (one device-to-host copy per tensor)."""
        host = [x.cpu().numpy() for x in self.assemble(effs)]
        return [tuple(h[g] for h in host) for g in range(len(effs))]

    def sweep(self, e, ts, *, mode: str = "sum", want_stack: bool = False):
        """The batched DP for slices ``(e[:, s], ts[s])``: ``e`` (N, S) is
        each slice's effective batch, ``ts`` its threshold.

        Returns ``(best_val, best_k, best_m, stack)`` on the device, in the
        backend's dtype.  Without ``want_stack`` it is one K1 launch over
        the distinct graphs (``best_k``, ``best_m`` and ``stack`` None);
        with it, the plain-torch sweep on each slice's graph and its
        per-layer dist tensors (``stack[k - 2]`` is (S, N, I+1))."""
        obs.inc("planner.device_dispatches")
        cols, inv = np.unique(np.asarray(e, dtype=np.float64).T, axis=0,
                              return_inverse=True)
        inv = inv.reshape(-1)
        graphs = self.assemble(cols)
        ts = torch.as_tensor(ts, dtype=torch.float64,
                             device=self.device).to(self.dtype).reshape(-1)
        if not want_stack:
            if len(cols) == 1:
                best = sweep_minplus(*(x[0] for x in graphs), self.K, ts,
                                     mode=mode)
            else:
                best = sweep_minplus(*graphs, self.K, ts, mode=mode,
                                     graph=inv)
            return best, None, None, None
        sel = torch.as_tensor(inv, device=self.device)
        out = _sweep(*(x[sel] for x in graphs), self.K, ts, mode=mode,
                     want_parents=False, want_stack=True)
        return out.best_val, out.best_k, out.best_m, out.stack


def host_mirror(factory, b: int, dtype) -> tuple:
    """The graph of micro-batch ``b`` as the device backend assembles it in
    ``dtype``, as host numpy arrays ``(Ccom, Bcom, Sseg, Bseg, src_cost,
    src_beta)`` in ``_LayeredDP``'s layout — the operands of
    :func:`backtrace_stack` and of the β windows.  They are the device
    tensors themselves, copied, so the backtrace's sums are the sweep's."""
    return DeviceDP(factory, 1, dtype).mirrors(
        factory.effective_batch(b)[None])[0]


def _host_stack(stack, S: int, N: int, I1: int) -> np.ndarray:
    """A sweep's per-layer dist tensors as one host array (layers, S, N,
    I+1): a single device-to-host copy."""
    if not stack:                                   # K = 1: no layer ran
        return np.empty((0, S, N, I1))
    return torch.stack(stack).cpu().numpy()


# ---------------------------------------------------------------------------
# Path reconstruction and repricing
# ---------------------------------------------------------------------------

def backtrace_stack(stack, mirror, t: float, k: int, m: int, j: int) -> list:
    """Rebuild one slice's path from its per-layer dist stack (host arrays).

    ``stack[k - 2]`` is dist after layer k (layer 1 is the source row).  At
    each step the parent ``(n, i)`` of state ``(k, m, j)`` comes from
    re-running the two-stage relaxation for the one column needed and
    taking ``np.argmin`` — the same candidates, in the same order, as a
    parent-tracking sweep's first-minimum argmin, so ties break alike
    (``mirror`` holds the very values the sweep read)."""
    Ccom, Bcom, Sseg, Bseg, src_cost, src_beta = mirror
    if k == 1:
        return [(0, j)]
    path = [(int(m), int(j))]
    N, I1 = Ccom.shape[0], Ccom.shape[1]
    dt = Ccom.dtype
    t = dt.type(t)
    inf = dt.type(_INF)
    src = np.where(src_beta <= t, src_cost, inf)
    for kk in range(k, 1, -1):
        if kk >= 3:
            prev = stack[kk - 3]                          # dist after kk-1
        else:
            prev = np.full((N, I1), inf, dtype=dt)
            prev[0] = src
        Vc = np.where(Bcom[:, :, m] <= t, Ccom[:, :, m], inf)   # (N, I1)
        A = (prev + Vc).min(axis=0)                             # (I1,)
        Vs = np.where(Bseg[:, m, j] <= t, Sseg[:, m, j], inf)   # (I1,)
        i = int(np.argmin(A + Vs))
        n = int(np.argmin(prev[:, i] + Vc[:, i]))
        path.append((n, i))
        m, j = n, i
    path.reverse()
    return path


def reprice_paths(g, paths: list) -> list:
    """``(cost, beta)`` of each path on the float64 graph ``g``, with the
    DP's accumulation order ``(dist + comm) + seg`` in Python floats — equal
    to the DP's dist bit for bit.  The graph entries of every path come to
    the host in one gather and one copy."""
    dev = g.comm_cost.device
    src_i = torch.tensor([p[0][1] for p in paths], dtype=torch.long,
                         device=dev)
    hops = [(pi, pn, n, i) for p in paths
            for (pn, pi), (n, i) in zip(p[:-1], p[1:])]
    parts = [g.src_cost[src_i], g.src_beta[src_i]]
    if hops:
        i0, n0, n1, i1 = torch.tensor(hops, dtype=torch.long,
                                      device=dev).unbind(1)
        parts += [g.comm_cost[i0, n0, n1], g.seg_cost[n1, i0, i1],
                  g.comm_beta[i0, n0, n1], g.seg_beta[n1, i0, i1]]
    vals = torch.cat(parts).tolist()
    P, H = len(paths), len(hops)
    cc, sc = vals[2 * P:2 * P + H], vals[2 * P + H:2 * P + 2 * H]
    cb, sb = vals[2 * P + 2 * H:2 * P + 3 * H], vals[2 * P + 3 * H:]
    out, h = [], 0
    for q, p in enumerate(paths):
        cost, beta = vals[q], vals[P + q]
        for _ in p[1:]:
            cost = (cost + cc[h]) + sc[h]
            beta = max(beta, cb[h], sb[h])
            h += 1
        out.append((cost, beta))
    return out


def reprice_dp_order(g, path) -> tuple:
    """(cost, beta) of one path on graph ``g`` (:func:`reprice_paths`)."""
    return reprice_paths(g, [path])[0]


# ---------------------------------------------------------------------------
# The batched solve_many (phases A-D on the device)
# ---------------------------------------------------------------------------

def solve_many_device(planner, bs: list, B: int, K: int | None = None,
                      dtype=torch.float32) -> list:
    """``Planner.solve_many`` on the device backend, phase for phase as the
    exact backend, plus the reference's cross-b upper bounds: every phase
    A / P path is repriced (float64) on every live graph, which narrows
    the phase-C windows — valid because any real path's objective bounds
    the optimum from above, and a window holding every global minimizer
    gives the same first-minimum winner.  Phases B and C are one K1 launch
    each."""
    K = planner.default_K(K)
    ddp = planner._device_dp(K, dtype)
    fac = planner.factory
    S, I = len(bs), fac.I
    e = np.stack([fac.effective_batch(b) for b in bs], axis=1)   # (N, S)
    xi = [L.num_fills(B, b) for b in bs]
    mirrors = planner._device_mirrors(bs, ddp)
    graphs = [planner.graph(b) for b in bs]

    # phase A: full-graph run for every b (dist stack -> host backtrace)
    bestA, kA, mA, stackA = ddp.sweep(e, np.full(S, _INF), want_stack=True)
    bestA, kA, mA = bestA.tolist(), kA.tolist(), mA.tolist()
    N, I1 = fac.N, I + 1
    hostA = _host_stack(stackA, S, N, I1)
    paths_full = [backtrace_stack(hostA[:, s], mirrors[s], _INF, kA[s],
                                  mA[s], I) if kA[s] else None
                  for s in range(S)]
    results: list = [None] * S
    live = []
    for s in range(S):
        if xi[s] == 0 or paths_full[s] is None:
            results[s] = _finish_repriced(planner, graphs[s], paths_full[s],
                                          bs[s], B, xi[s], 1)
        else:
            live.append(s)
    if not live:
        return results

    # phase B: one K1 launch of (max, min) sweeps -> beta* per live b, then
    # a probe at beta* (dist stack -> the upper-bound path)
    el = e[:, live]
    beta_star = ddp.sweep(el, np.full(len(live), _INF),
                          mode="max")[0].tolist()
    _, kP, mP, stackP = ddp.sweep(el, beta_star, want_stack=True)
    kP, mP = kP.tolist(), mP.tolist()
    hostP = _host_stack(stackP, len(live), N, I1)
    paths_star = [backtrace_stack(hostP[:, q], mirrors[live[q]],
                                  beta_star[q], kP[q], mP[q], I)
                  if kP[q] else None for q in range(len(live))]

    # cross-b upper bounds: every candidate path repriced on every live b.
    # The cap is float64 and the window's betas are the backend's; in
    # float32 a minimizer's beta can round above a cap that is itself the
    # minimizer's float64 beta, so the cap gets the float32 tolerance as
    # slack (none in float64: the reference's window exactly)
    slack = parity_tolerance(dtype)
    pool = [p for p in paths_full + paths_star if p is not None]
    windows = []
    for q, s in enumerate(live):
        ub = _INF
        for c, beta in reprice_paths(graphs[s], pool):
            if math.isfinite(c):
                ub = min(ub, c + xi[s] * beta)
        cap = (ub - bestA[s] * (1 - slack)) / xi[s] * (1 + slack)
        _, Bcom_m, _, Bseg_m, _, src_beta_m = (torch.from_numpy(x)
                                               for x in mirrors[s])
        w = _betas_from_arrays(Bcom_m, Bseg_m, src_beta_m, beta_star[q],
                               cap * (1 + 1e-12) + 1e-12)
        w = torch.unique(torch.cat(w).double(), sorted=True).numpy()
        if w.size == 0:
            w = np.array([beta_star[q]])
        windows.append(w)

    # phase C: ONE K1 launch over every (b, threshold) pair, then the argmin
    # per b (first minimum: the smallest t)
    slice_q = np.concatenate([np.full(len(w), q)
                              for q, w in enumerate(windows)])
    dvals = ddp.sweep(el[:, slice_q], np.concatenate(windows))[0]
    dvals = dvals.double().cpu().numpy()
    t_hat = np.empty(len(live))
    pos = 0
    for q, w in enumerate(windows):
        H = dvals[pos:pos + len(w)] + xi[live[q]] * w
        t_hat[q] = w[int(np.argmin(H))]
        pos += len(w)

    # phase D: reconstruction at the winners (the probe's path where the
    # winner is beta*)
    need = [q for q in range(len(live)) if t_hat[q] != beta_star[q]]
    if need:
        _, kR, mR, stackR = ddp.sweep(el[:, need], t_hat[need],
                                      want_stack=True)
        kR, mR = kR.tolist(), mR.tolist()
        hostR = _host_stack(stackR, len(need), N, I1)
        for r, q in enumerate(need):
            s = live[q]
            path = (backtrace_stack(hostR[:, r], mirrors[s], float(t_hat[q]),
                                    kR[r], mR[r], I) if kR[r] else None)
            results[s] = _finish_repriced(planner, graphs[s], path, bs[s], B,
                                          xi[s], 5)
    for q, s in enumerate(live):
        if results[s] is None:
            results[s] = _finish_repriced(planner, graphs[s], paths_star[q],
                                          bs[s], B, xi[s], 4)
    return results


def _finish_repriced(planner, g, path, b, B, xi, sweeps):
    """An MSPResult whose objective is the chosen path repriced in float64
    on the planner's graph — exact for a float32-chosen path, and equal to
    the exact backend's in float64."""
    if path is None:
        return planner._finish(g, _INF, None, b, B, xi, sweeps, "batched")
    cost, _ = reprice_dp_order(g, path)
    return planner._finish(g, cost, path, b, B, xi, sweeps, "batched")


def dist_at_device(dp, ts, planner, dtype=torch.float32) -> torch.Tensor:
    """dist(t) for every threshold of ``ts`` on the graph bound to ``dp``,
    as the device backend assembles it in ``dtype``: one K1 launch; float64
    out.  A restricted DP runs its exact masked sweep
    (``planner.masked_sweeps``), as the reference does."""
    if dp.restricted:
        return dp.dist_at(ts)
    ddp = planner._device_dp(dp.K, dtype)
    ts = torch.as_tensor(ts, dtype=torch.float64,
                         device=planner.device).reshape(-1)
    eff = planner.factory.effective_batch(dp.g.b)
    e = np.repeat(eff[:, None], ts.numel(), axis=1)
    return ddp.sweep(e, ts)[0].double()
