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

where q = r exp(L_{t-1}) and k' = k exp(-L).  All arithmetic is float32.
Layouts: r/k/v/logw (B, S, H, hd); u (H, hd); s0 (B, H, hd, hd).  Both
return (y (B, S, H, hd) float32, S_final (B, H, hd, hd) float32).
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
