"""Plain PyTorch version of the min-plus sweep kernel (K1).

The same function as ``csrc/minplus.cu`` written with torch ops: the
two-stage layered relaxation of ``repro_torch.core.shortest_path`` for one
graph and a batch of thresholds (or, with ``graph=``, for stacked graphs
and a graph per threshold), returning only the best terminal value per
threshold.  The wrapper uses it for tensors on the CPU, the tests hold it
against the reference's ``sweep_ref`` / ``_LayeredDP.dist_at``, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
``sweep_cluster_plain`` restates the same sweep as the CUDA kernel's
cluster route decomposes it (per-block destination ranges, a dist
all-gather per layer, a cluster-wide early exit, a final min); it is used by
the tests and ``chip_smoke.py`` only.

Every operation is ``+``, ``max``, ``min`` or a compare, so in float64 the
result is exactly rounded whatever order the reductions take.
"""

from __future__ import annotations

import torch


def slices_per_chunk(N: int, I1: int) -> int:
    """Cap the slice axis so one chunk's candidate tensors stay ~64 MB."""
    return max(1, int(2 ** 23 // max(1, N * I1 * max(N, I1))))


def sweep_plain(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts,
                mode: str = "sum", graph=None) -> torch.Tensor:
    """Best terminal value per threshold, shape ``ts.shape``.

    Layouts: ``Ccom/Bcom[n, i, m]``, ``Sseg/Bseg[i, m, j]``,
    ``src_cost/src_beta[i]`` (structural masks pre-folded, as after
    ``_LayeredDP.rebind``).  ``mode="sum"`` is (+, min) shortest path among
    edges with beta <= t; ``mode="max"`` is (max, min) minimal bottleneck.
    With ``graph`` (S graph indices) the tensors carry a leading axis of
    graphs and threshold s is swept on graph ``graph[s]``.
    """
    ts = torch.as_tensor(ts, dtype=Ccom.dtype, device=Ccom.device).reshape(-1)
    if graph is not None:
        idx = torch.as_tensor(graph).reshape(-1).to("cpu", torch.int64)
        out = torch.empty_like(ts)
        for g in torch.unique(idx).tolist():
            sel = torch.nonzero(idx == g).flatten().to(ts.device)
            out[sel] = sweep_plain(Ccom[g], Bcom[g], Sseg[g], Bseg[g],
                                   src_cost[g], src_beta[g], K, ts[sel],
                                   mode)
        return out
    N, I1 = Ccom.shape[0], Ccom.shape[1]
    per = slices_per_chunk(N, I1)
    out = torch.empty_like(ts)
    for c0 in range(0, ts.shape[0], per):
        out[c0:c0 + per] = _sweep_chunk(Ccom, Bcom, Sseg, Bseg, src_cost,
                                        src_beta, K, ts[c0:c0 + per], mode)
    return out


def _sweep_chunk(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts, mode):
    is_sum = mode == "sum"
    op = torch.add if is_sum else torch.maximum
    src_val = src_cost if is_sum else src_beta
    inf = torch.tensor(float("inf"), dtype=Ccom.dtype, device=Ccom.device)
    S = ts.shape[0]
    N, I1 = Ccom.shape[0], Ccom.shape[1]
    I = I1 - 1

    dist = torch.full((S, N, I1), float("inf"), dtype=Ccom.dtype,
                      device=Ccom.device)
    dist[:, 0, :] = torch.where(src_beta <= ts[:, None], src_val, inf)
    best = dist[:, 0, I].clone()
    # the threshold mask is layer-independent: fold beta > t edges to inf
    t4 = ts[:, None, None, None]
    Vc = torch.where(Bcom <= t4, Ccom if is_sum else Bcom, inf)
    Vs = torch.where(Bseg <= t4, Sseg if is_sum else Bseg, inf)
    for _k in range(2, K + 1):
        A = op(dist[:, :, :, None], Vc).amin(dim=1)        # (S, I1, N)
        nd = op(A[:, :, :, None], Vs).amin(dim=1)          # (S, N, I1)
        dist = nd
        if N > 1:
            best = torch.minimum(best, nd[:, 1:, I].amin(dim=1))
        if not torch.isfinite(nd).any():
            break
    return best


def cluster_ranges(N: int, C: int) -> list:
    """The destination nodes ``[m0, m1)`` of each of the C blocks of one
    threshold's cluster: ``[r N // C, (r + 1) N // C)``, as ``minplus.cu``
    splits them (uneven when C does not divide N; empty when C > N)."""
    return [(r * N // C, (r + 1) * N // C) for r in range(C)]


def sweep_cluster_plain(Ccom, Bcom, Sseg, Bseg, src_cost, src_beta, K, ts,
                        mode: str = "sum", C: int = 1,
                        graph=None) -> torch.Tensor:
    """``sweep_plain`` computed as the cluster route computes it, one
    threshold at a time: block r keeps the masked slices ``Vc[:, :, M_r]``
    and ``Vs[:, M_r, :]``; each layer it computes ``A[:, M_r]`` from the
    whole ``dist`` and its own rows ``dist'[M_r, :]``, and the rows of all
    blocks are gathered into the next ``dist``; the sweep stops when no
    block holds a finite state; each block keeps the best of its own
    terminal rows, and the blocks' bests are reduced at the end.  With
    ``graph`` a threshold's cluster reads graph ``graph[s]`` of the stacked
    tensors in place, as the kernel offsets its base pointers."""
    is_sum = mode == "sum"
    op = torch.add if is_sum else torch.maximum
    ts = torch.as_tensor(ts, dtype=Ccom.dtype, device=Ccom.device).reshape(-1)
    inf = torch.tensor(float("inf"), dtype=Ccom.dtype, device=Ccom.device)
    N, I1 = Ccom.shape[-3], Ccom.shape[-2]
    I = I1 - 1
    ranges = cluster_ranges(N, C)
    out = torch.empty_like(ts)
    stacked = (Ccom, Bcom, Sseg, Bseg, src_cost, src_beta)
    for s, t in enumerate(ts):
        if graph is not None:
            g = int(graph[s])
            Ccom, Bcom, Sseg, Bseg, src_cost, src_beta = (x[g]
                                                          for x in stacked)
        Vc = [torch.where(Bcom[:, :, m0:m1] <= t,
                          (Ccom if is_sum else Bcom)[:, :, m0:m1], inf)
              for m0, m1 in ranges]
        Vs = [torch.where(Bseg[:, m0:m1] <= t,
                          (Sseg if is_sum else Bseg)[:, m0:m1], inf)
              for m0, m1 in ranges]
        dist = torch.full((N, I1), float("inf"), dtype=Ccom.dtype,
                          device=Ccom.device)
        dist[0] = torch.where(src_beta <= t, src_cost if is_sum else src_beta,
                              inf)
        bests = [inf] * C
        for _k in range(2, K + 1):
            rows, live = [], False
            for r, (m0, m1) in enumerate(ranges):
                A = op(dist[:, :, None], Vc[r]).amin(dim=0)     # (I1, M_r)
                nd = op(A[:, :, None], Vs[r]).amin(dim=0)       # (M_r, I1)
                rows.append(nd)
                live = live or bool(torch.isfinite(nd).any())
                own = nd[max(0, 1 - m0):, I]                    # m >= 1
                if own.numel():
                    bests[r] = torch.minimum(bests[r], own.amin())
            dist = torch.cat(rows)                              # all-gather
            if not live:
                break
        best = torch.where(src_beta[I] <= t,
                           (src_cost if is_sum else src_beta)[I], inf)
        for b in bests:
            best = torch.minimum(best, b)
        out[s] = best
    return out
