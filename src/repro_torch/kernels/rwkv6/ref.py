"""Plain PyTorch versions of the RWKV6 WKV scan (K3).

``wkv6_plain`` is the per-token recurrence (the port of
``repro/kernels/rwkv6/ref.py::wkv6_ref``, the oracle):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

``wkv6_chunked_plain`` is the chunked form the kernel computes (the port of
``repro/models/rwkv6.py::wkv_chunked``): within a chunk, with
L = cumsum(log w),

    y   = q S + tril(q k'^T, -1) v + (r . u . k) v
    S  <- exp(L_C) S + (k exp(L_C - L))^T v

where q = r exp(L_{t-1}) and k' = k exp(-L).

``wkv6_tiled_plain`` is the decomposition the CUDA kernel computes, in
plain PyTorch (used by the tests and ``chip_smoke.py``): tiles of ``tile``
tokens that ignore the chunk, in two passes.  Pass 1 walks the tiles and
keeps the state entering each; pass 2 computes every tile's outputs from
its entering state, with the exponents taken relative to a boundary of
``sub``-token sub-tiles so that no factor exceeds 1 (see its docstring).

All arithmetic is float32.  Layouts: r/k/v/logw (B, S, H, hd); u (H, hd);
s0 (B, H, hd, hd).  All return (y (B, S, H, hd) float32, S_final
(B, H, hd, hd) float32).

``wkv6_bwd_plain`` is the backward K3' computes (``csrc/wkv6_bwd.cu``):
the reverse walk of the recurrence with G_t = dL/dS_t (G_T = dS_final),

    dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
    dk_t = G_t v_t + u o r_t (v_t . dy_t)
    dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t
    G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0
    du = sum_t r_t o k_t (v_t . dy_t)

and dlogw from running sums instead of a per-token product of S and G:
with A_t = r_t o (S_{t-1} dy_t) and B_t = k_t o (G_t v_t),

    dlogw_t = sum_j (S_T o dS_final)[:, j] + sum_{tau>t} A_tau - sum_{s>=t} B_s

(since w_t S_{t-1} = S_t - k_t v_t^T).  The forward walk that gives
S_{t-1} dy_t never divides by w, which under a strong decay overflows.

``wkv6_bwd_tiled_plain`` is the same backward in the decomposition the
CUDA kernel computes: the gradient state at each tile's end by a reverse
walk over the tiles (pass B1), then every tile from its entering state and
that gradient state (pass B2), with dlogw from c_t = rowsum(S_t o G_t) at
the tile's end and the recursion c_{t-1} = c_t + A_t - B_t inside it (see
its docstring).
"""

from __future__ import annotations

import torch


def wkv6_plain(r, k, v, logw, u, s0):
    rf, kf, vf = (t.float() for t in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               S + uf[None, :, :, None] * kv))
        S = w[:, t][..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_chunked_plain(r, k, v, logw, u, s0, chunk: int):
    B, S, H, hd = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"chunk {chunk}")
    uf = u.float()
    S_prev = s0.float()
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lwc = (t[:, c0:c0 + chunk].float()
                           for t in (r, k, v, logw))       # (B, C, H, hd)
        L = torch.cumsum(lwc, dim=1)                       # inclusive
        Lm1 = L - lwc                                      # exclusive
        q = rc * torch.exp(Lm1)                            # decayed queries
        kd = kc * torch.exp(L[:, -1:] - L)                 # keys to chunk end
        y_cross = torch.einsum("bchk,bhkv->bchv", q, S_prev)
        att = torch.einsum("bchk,bThk->bhcT", q, kc * torch.exp(-L))
        att = torch.where(mask, att, 0.0)
        y_intra = torch.einsum("bhcT,bThv->bchv", att, vc)
        y_diag = torch.einsum("bchk,bchk->bch", rc, uf[None, None] * kc)
        ys.append(y_cross + y_intra + y_diag[..., None] * vc)
        S_prev = (torch.exp(L[:, -1])[..., None] * S_prev
                  + torch.einsum("bThk,bThv->bhkv", kd, vc))
    return torch.cat(ys, dim=1), S_prev



def _suffix(lw, dim: int = 1):
    """Exclusive suffix sums along ``dim``: out[t] = sum of lw[t+1:], each
    a sum of terms of one sign (never a difference of two cumsums, which
    loses the small exponents that matter to cancellation)."""
    inc = torch.flip(torch.cumsum(torch.flip(lw, [dim]), dim), [dim])
    return torch.cat([inc.narrow(dim, 1, inc.shape[dim] - 1),
                      torch.zeros_like(inc.narrow(dim, 0, 1))], dim)


def _tile_states(k, v, lw, s0, tile: int):
    """Pass 1 of the tiled forward: the state entering each ``tile``-token
    tile (a list) and the final state, with G = the suffix sums of log w
    within the tile and tot their total:
        S <- exp(tot) S + (k exp(G))^T v"""
    states, Sc = [], s0.float()
    for t0 in range(0, k.shape[1], tile):
        states.append(Sc)
        kc, vc, lc = (x[:, t0:t0 + tile] for x in (k, v, lw))
        kt = kc * torch.exp(_suffix(lc))
        Sc = (torch.exp(lc.sum(1))[..., None] * Sc
              + torch.einsum("bthk,bthv->bhkv", kt, vc))
    return states, Sc


def wkv6_tiled_plain(r, k, v, logw, u, s0, tile: int = 64, sub: int = 16):
    """The kernel's two passes over ``tile``-token tiles (the last one
    ragged), whatever the chunk.

    Pass 1, the state entering each tile, with G = the suffix sums of
    log w within the tile (G_t = sum over t' > t) and tot their total:
        S <- exp(tot) S + (k exp(G))^T v
    Pass 2, each tile's outputs from its entering state S.  Within each
    ``sub``-token sub-tile J: F = cumsum(log w) from the sub-tile's start,
    F-_t = F_{t-1} (0 at the start), G = the suffix sums to its end and
    tot_J their total.  For a query t in sub-tile I, with
    q^ = r exp(F-) and Lam_I = sum of tot_J over J < I:
        y = q^ (exp(Lam_I) S)                          earlier tiles
          + sum_{J<I} (q^ (k exp(G) D_IJ)^T) v_J       earlier sub-tiles
          + (sum_i r k exp(F-_t - F_tau)) v_tau         own sub-tile, tau < t
          + (r . u . k) v                              the current token
    where D_IJ = exp(sum of tot_J' for J < J' < I).  Every exponent is a
    sum of log w over tokens, so for log w <= 0 no factor exceeds 1 and
    nothing overflows, whatever the decay.
    """
    B, S, H, hd = r.shape
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    starts = range(0, S, tile)
    states, Sc = _tile_states(kf, vf, lw, s0, tile)
    # pass 2
    ys = []
    for t0, St in zip(starts, states):
        rc, kc, vc, lc = (x[:, t0:t0 + tile] for x in (rf, kf, vf, lw))
        subs = [(a, min(a + sub, rc.shape[1]))
                for a in range(0, rc.shape[1], sub)]
        F = [torch.cumsum(lc[:, a:e], 1) for a, e in subs]
        tot = [f[:, -1] for f in F]                       # (B, H, hd)
        kg = [kc[:, a:e] * torch.exp(_suffix(lc[:, a:e])) for a, e in subs]
        for I, (a, e) in enumerate(subs):
            Fm = torch.cat([torch.zeros_like(F[I][:, :1]), F[I][:, :-1]], 1)
            qh = rc[:, a:e] * torch.exp(Fm)
            lam = sum(tot[:I], torch.zeros_like(tot[0]))
            y = torch.einsum("bthk,bhkv->bthv", qh,
                             torch.exp(lam)[..., None] * St)
            for J in range(I):
                D = torch.exp(sum(tot[J + 1:I], torch.zeros_like(tot[0])))
                att = torch.einsum("bthk,bThk->bhtT", qh, kg[J] * D[:, None])
                aJ, eJ = subs[J]
                y = y + torch.einsum("bhtT,bThv->bthv", att, vc[:, aJ:eJ])
            d = Fm[:, :, None] - F[I][:, None]             # (B, t, T, H, hd)
            n = e - a
            lower = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                          device=r.device), diagonal=-1)
            d = torch.where(lower[None, :, :, None, None], d, -torch.inf)
            att = torch.einsum("bthk,bThk,btThk->bhtT", rc[:, a:e],
                               kc[:, a:e], torch.exp(d))
            y = y + torch.einsum("bhtT,bThv->bthv", att, vc[:, a:e])
            bonus = torch.einsum("bthk,bthk->bth", rc[:, a:e],
                                 uf[None, None] * kc[:, a:e])
            ys.append(y + bonus[..., None] * vc[:, a:e])
    return torch.cat(ys, dim=1), Sc


def wkv6_bwd_plain(r, k, v, logw, u, s0, dy, ds_final):
    """(dr, dk, dv, dlogw, du, ds0) of the scan at the output gradients
    ``dy`` (B, S, H, hd) and ``ds_final`` (B, H, hd, hd), all float32; du
    is summed over the batch, as u is shared."""
    rf, kf, vf, lw, dyf = (t.float() for t in (r, k, v, logw, dy))
    w = torch.exp(lw)
    uf = u.float()
    Sc = s0.float()
    a = []                                   # S_{t-1} dy_t
    for t in range(r.shape[1]):
        a.append(torch.einsum("bhkv,bhv->bhk", Sc, dyf[:, t]))
        Sc = (w[:, t][..., None] * Sc
              + torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t]))
    G = ds_final.float()
    c = (Sc * G).sum(-1)                     # P_T
    du = torch.zeros_like(Sc[..., 0])
    dr, dk, dv, dlw = [], [], [], []
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, dyt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)
        gv = torch.einsum("bhkv,bhv->bhk", G, vt)
        bt = kt * gv
        dr.append(a[t] + uf * kt * vdy)
        dk.append(gv + uf * rt * vdy)
        dv.append(torch.einsum("bhkv,bhk->bhv", G, kt)
                  + (rt * uf * kt).sum(-1, keepdim=True) * dyt)
        dlw.append(c - bt)
        c = c + rt * a[t] - bt
        du = du + rt * kt * vdy
        G = w[:, t][..., None] * G + torch.einsum("bhk,bhv->bhkv", rt, dyt)
    grads = [torch.stack(x[::-1], dim=1) for x in (dr, dk, dv, dlw)]
    return (*grads, du.sum(0), G)


def _prefix(lw, dim: int = 1):
    """Exclusive prefix sums along ``dim``: out[t] = sum of lw[:t]."""
    inc = torch.cumsum(lw, dim)
    return torch.cat([torch.zeros_like(inc.narrow(dim, 0, 1)),
                      inc.narrow(dim, 0, inc.shape[dim] - 1)], dim)


def _pairs(Fm_late, F_early, later: bool):
    """exp(F-_late - F_early) of every (t, s) pair of a sub-tile, shape
    (B, t, s, H, hd), where the later token is s (``later``) or t; 0 off
    the strict triangle.  Both are local sums from the sub-tile's start, so
    each exponent is the sum of log w strictly between the two tokens."""
    n = Fm_late.shape[1]
    if later:      # s > t: exp(F-_s - F_t)
        d = Fm_late[:, None] - F_early[:, :, None]
        keep = torch.triu(torch.ones(n, n, dtype=torch.bool,
                                     device=d.device), diagonal=1)
    else:          # s < t: exp(F-_t - F_s)
        d = Fm_late[:, :, None] - F_early[:, None]
        keep = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                     device=d.device), diagonal=-1)
    return torch.exp(torch.where(keep[None, :, :, None, None], d,
                                 -torch.inf))


def wkv6_bwd_tiled_plain(r, k, v, logw, u, s0, dy, ds_final,
                         tile: int = 64, sub: int = 16):
    """(dr, dk, dv, dlogw, du, ds0) as :func:`wkv6_bwd_plain`, in the
    decomposition K3' computes over ``tile``-token tiles (the last one
    ragged) of ``sub``-token sub-tiles.

    Pass B1, the gradient state G at each tile's end, walking the tiles
    from last to first from G = dS_final, with F- the exclusive prefix sums
    of log w over the tile and tot their total:
        G <- exp(tot) G + (r exp(F-))^T dy;   the last G is ds0.
    Pass B2, each tile from the state S entering it (the forward's pass 1)
    and G at its end.  Within sub-tile J: F = cumsum(log w) from its start,
    F-_t = F_{t-1} (0 at the start), tot_J its total.  A forward walk over
    the sub-tiles, S at each one's start:
        a_t = exp(F-_t) o (S_J dy_t)
              + sum_{s<t in J} (dy_t . v_s) k_s exp(F-_t - F_s)
        S_{J+1} = exp(tot_J) S_J + (k exp(tot_J - F))^T v
    then a backward walk, G at each one's end:
        g_t = exp(tot_J - F_t) o (G_J v_t)
              + sum_{s>t in J} (dy_s . v_t) r_s exp(F-_s - F_t)
        dv_t = (k_t exp(tot_J - F_t)) G_J
               + sum_{s>t in J} (sum_i r_s k_t exp(F-_s - F_t)) dy_s
               + (r . u . k)_t dy_t
        G_{J-1} = exp(tot_J) G_J + (r exp(F-))^T dy
    and dr = a + u k (v . dy), dk = g + u r (v . dy), A = r o a,
    B = k o g, dlogw_t = c_t - B_t with c at the tile's end rowsum(S o G)
    (the last sub-tile's S, B1's G) and c_{t-1} = c_t + A_t - B_t.  Every
    exponent is a sum of log w over tokens, none spanning two sub-tiles as
    a difference: exact under any decay.
    """
    B, S, H, hd = r.shape
    rf, kf, vf, lw, dyf = (t.float() for t in (r, k, v, logw, dy))
    uf = u.float()
    starts = list(range(0, S, tile))
    states, _ = _tile_states(kf, vf, lw, s0, tile)
    cut = lambda x, a, e: x[:, a:e]
    # pass B1
    G, g_ends = ds_final.float(), [None] * len(starts)
    for j in reversed(range(len(starts))):
        g_ends[j] = G
        t0 = starts[j]
        rc, lc, yc = (cut(x, t0, t0 + tile) for x in (rf, lw, dyf))
        G = (torch.exp(lc.sum(1))[..., None] * G
             + torch.einsum("bthk,bthv->bhkv", rc * torch.exp(_prefix(lc)),
                            yc))
    ds0 = G
    # pass B2
    outs = {name: [] for name in ("dr", "dk", "dv", "dlw")}
    du = torch.zeros_like(uf)
    for t0, S_in, G_end in zip(starts, states, g_ends):
        rc, kc, vc, lc, yc = (cut(x, t0, t0 + tile)
                              for x in (rf, kf, vf, lw, dyf))
        subs = [(a, min(a + sub, rc.shape[1]))
                for a in range(0, rc.shape[1], sub)]
        F = [torch.cumsum(lc[:, a:e], 1) for a, e in subs]
        Fm = [_prefix(lc[:, a:e]) for a, e in subs]
        tot = [f[:, -1] for f in F]
        part = lambda x, J: x[:, subs[J][0]:subs[J][1]]
        M = [torch.einsum("bthj,bshj->bhts", part(yc, J), part(vc, J))
             for J in range(len(subs))]
        # forward walk
        a_, S_ = [], S_in
        for J in range(len(subs)):
            kJ, vJ, yJ = part(kc, J), part(vc, J), part(yc, J)
            cross = torch.exp(Fm[J]) * torch.einsum("bthj,bhij->bthi", yJ,
                                                   S_)
            own = torch.einsum("bhts,bshi,btshi->bthi", M[J], kJ,
                               _pairs(Fm[J], F[J], later=False))
            a_.append(cross + own)
            S_ = (torch.exp(tot[J])[..., None] * S_
                  + torch.einsum("bshi,bshj->bhij",
                                 kJ * torch.exp(tot[J][:, None] - F[J]), vJ))
        c_end = (S_ * G_end).sum(-1)
        # backward walk
        g_, dv_, G_ = [None] * len(subs), [None] * len(subs), G_end
        for J in reversed(range(len(subs))):
            rJ, kJ, vJ, yJ = (part(x, J) for x in (rc, kc, vc, yc))
            decay = torch.exp(tot[J][:, None] - F[J])
            pairs = _pairs(Fm[J], F[J], later=True)
            g_[J] = (decay * torch.einsum("bthj,bhij->bthi", vJ, G_)
                     + torch.einsum("bhst,bshi,btshi->bthi", M[J], rJ,
                                    pairs))
            att = torch.einsum("bshi,bthi,btshi->bhst", rJ, kJ, pairs)
            bonus = (rJ * uf * kJ).sum(-1, keepdim=True)
            dv_[J] = (torch.einsum("bthi,bhij->bthj", kJ * decay, G_)
                      + torch.einsum("bhst,bshj->bthj", att, yJ)
                      + bonus * yJ)
            G_ = (torch.exp(tot[J])[..., None] * G_
                  + torch.einsum("bshi,bshj->bhij", rJ * torch.exp(Fm[J]),
                                 yJ))
        a_, g_, dv_ = (torch.cat(x, 1) for x in (a_, g_, dv_))
        vdy = (vc * yc).sum(-1, keepdim=True)
        A_, B_ = rc * a_, kc * g_
        # dlogw_t = c_end + sum_{s>t} (A_s - B_s) - B_t
        outs["dlw"].append(c_end[:, None] + _suffix(A_ - B_) - B_)
        outs["dr"].append(a_ + uf * kc * vdy)
        outs["dk"].append(g_ + uf * rc * vdy)
        outs["dv"].append(dv_)
        du = du + (rc * kc * vdy).sum((0, 1))
    dr, dk, dv, dlw = (torch.cat(outs[x], 1) for x in ("dr", "dk", "dv",
                                                       "dlw"))
    return dr, dk, dv, dlw, du, ds0
