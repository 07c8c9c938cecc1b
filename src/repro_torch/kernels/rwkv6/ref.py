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
    # pass 1
    states, Sc = [], s0.float()
    for t0 in starts:
        states.append(Sc)
        kc, vc, lc = (x[:, t0:t0 + tile] for x in (kf, vf, lw))
        kt = kc * torch.exp(_suffix(lc))
        Sc = (torch.exp(lc.sum(1))[..., None] * Sc
              + torch.einsum("bthk,bthv->bhkv", kt, vc))
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
