"""Mamba (selective SSM) block, the Jamba hybrid's attention-free layer —
the port of ``repro/models/mamba.py``.

Mamba-1: rms-norm, in-proj to (x, z), a depthwise causal convolution over
time, SiLU, the input-dependent dt / B / C (``x_proj``, then ``dt_proj``
and a softplus), a diagonal A = -exp(A_log), the selective scan

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,    y_t = h_t C_t

in float32, the ``+ x D`` skip, the SiLU(z) gate, out-proj and the
residual.  Decode keeps (conv_state (B, dc-1, di), h (B, di, ds)) per
layer: an SSM's cache is O(1) in the sequence length.

The scan keeps the reference's structure: chunks of ``min(scan_chunk,
S)`` tokens with h carried between them, and inside a chunk a log-depth
scan of the (a, u) pairs (``common.scan_pairs``); the discretization and
the C-readout happen inside the chunk, so no (B, S, di, ds) tensor exists
beyond one chunk.  The reference halves its chunk until it divides S
(chunk 1 for an odd S); here the last chunk is shorter instead: the same
recurrence, a product order that differs only in rounding.  Every step is
a PyTorch op: the reference reaches no Pallas kernel here (its scan is
``jax.lax.associative_scan``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import (DATA, ArchConfig, CastCache, dense_init, lay_out,
                     maybe_constrain, rms_norm, scan_pairs)


def d_inner(cfg: ArchConfig) -> int:
    return cfg.mamba_expand * cfg.d_model


def dt_rank(cfg: ArchConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _shapes(cfg: ArchConfig) -> dict:
    """The block's parameters by shape, in the reference's order."""
    d, di, ds, dc = cfg.d_model, d_inner(cfg), cfg.mamba_d_state, \
        cfg.mamba_d_conv
    dtr = dt_rank(cfg)
    return {"in_proj": (d, 2 * di), "conv_w": (dc, di), "conv_b": (di,),
            "x_proj": (di, dtr + 2 * ds), "dt_proj": (dtr, di),
            "dt_bias": (di,), "A_log": (di, ds), "D": (di,),
            "out_proj": (di, d), "norm": (d,)}


class Mamba(nn.Module):
    """One Mamba block's parameters under the reference's names, in
    ``cfg.param_dtype`` and cast to the compute type at use (see
    ``CastCache``); ``A_log`` is read in float32."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name, shape in _shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=cfg.param_dtype, device=device)))
        self._cast = CastCache()

    def w(self, name: str, dtype) -> torch.Tensor:
        return self._cast.get(name, getattr(self, name), dtype)

    def forward(self, x, state=None):
        return mamba_fwd(self, x, state=state)


def init_mamba_params(m: Mamba, generator: torch.Generator) -> None:
    """The reference's initializer, drawn into ``m`` in place: the
    matrices truncated normal over sqrt(fan_in) (``conv_w``'s fan-in is
    the kernel width), ``conv_b`` 0, ``dt_bias`` -4.6 (softplus^-1 of
    0.01), ``A_log`` log(1..ds) in every row, ``D`` and ``norm`` 1."""
    cfg, pd = m.cfg, m.cfg.param_dtype
    with torch.no_grad():
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            p = getattr(m, name)
            p.copy_(dense_init(generator, tuple(p.shape), pd, p.device))
        m.conv_w.copy_(dense_init(generator, tuple(m.conv_w.shape), pd,
                                  m.conv_w.device, in_axis=0))
        m.conv_b.zero_()
        m.dt_bias.fill_(-4.6)
        A = torch.arange(1, cfg.mamba_d_state + 1, dtype=torch.float32,
                         device=m.A_log.device)
        m.A_log.copy_(torch.log(A).expand_as(m.A_log))
        m.D.fill_(1.0)
        m.norm.fill_(1.0)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: torch.Tensor | None = None) -> tuple:
    """Depthwise causal convolution along time: x (B, S, di), w (dc, di),
    b (di,); ``state`` (B, dc-1, di) is the tail of the previous segment
    (zeros when None).  Returns (y, new_state), new_state the last dc-1
    rows of the padded input (None when dc is 1)."""
    dc = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, dc - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(x_pad[:, i:i + S, :] * w[i] for i in range(dc))
    new_state = x_pad[:, -(dc - 1):, :] if dc > 1 else None
    return y + b, new_state


def selective_scan(dt, xin, Bv, Cf, A, h0, chunk: int) -> tuple:
    """y_t = h_t C_t with h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, in
    float32 chunks of ``chunk`` tokens (the last may be shorter): dt, xin
    (B, S, di), Bv (B, S, ds), Cf (B, S, ds) float32, A (di, ds), h0 (B, di,
    ds).  Returns (y (B, S, di) float32, h at the last token)."""
    h, ys = h0, []
    for s0 in range(0, dt.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        dt_k = dt[:, sl]
        a = torch.exp(dt_k.float()[..., None] * A)
        u = (dt_k * xin[:, sl]).float()[..., None] * \
            Bv[:, sl].float()[..., None, :]
        a, u = scan_pairs(a, u)
        h_all = a * h[:, None] + u
        del a, u
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cf[:, sl]))
        h = h_all[:, -1].clone()      # frees the chunk's states
        del h_all
    return torch.cat(ys, dim=1), h


def _scan_on_blocks(dt, xin, Bv, Cf, A, h0, chunk: int) -> tuple:
    """:func:`selective_scan`, on DTensors (the dry run's sharded layers)
    each rank's block through ``local_map``: the batch as dt's rows are
    split, d_inner as its channels (the scan is independent along both);
    B, C and the state follow.  Its many small ops then run on the blocks,
    not through DTensor's planning one by one.  On plain tensors as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dt, DTensor):
        return selective_scan(dt, xin, Bv, Cf, A, h0, chunk)
    from torch.distributed.tensor.experimental import local_map
    mesh = dt.device_mesh
    x_pl = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in dt.placements]
    n_pl = [p if p == Shard(0) else Replicate() for p in x_pl]
    a_pl = [Shard(0) if p == Shard(2) else Replicate() for p in x_pl]
    h_pl = [Shard(1) if p == Shard(2) else p for p in x_pl]
    args = [lay_out(t, mesh, pl) for t, pl in ((dt, x_pl), (xin, x_pl),
                                               (Bv, n_pl), (Cf, n_pl),
                                               (A, a_pl), (h0, h_pl))]
    return local_map(lambda *a: selective_scan(*a, chunk),
                     out_placements=(x_pl, h_pl),
                     in_placements=(x_pl, x_pl, n_pl, n_pl, a_pl, h_pl),
                     device_mesh=mesh)(*args)


def mamba_fwd(m: Mamba, x: torch.Tensor, *, state=None) -> tuple:
    """x (B, S, d) -> (out (B, S, d), (conv_state, h)).  ``state``:
    (conv_state, h) or None (a zero start).  With S == 1 and a state this
    is the O(1) decode step."""
    cfg = m.cfg
    B, S, _ = x.shape
    di, ds = d_inner(cfg), cfg.mamba_d_state
    dt_ = x.dtype
    conv_state, h0 = state if state is not None else (None, None)

    res = x
    x = rms_norm(x, m.norm, cfg.norm_eps)
    xin, z = (x @ m.w("in_proj", dt_)).chunk(2, dim=-1)
    xin, new_conv = causal_conv(xin, m.w("conv_w", dt_), m.w("conv_b", dt_),
                                conv_state)
    xin = F.silu(xin)
    dtr = dt_rank(cfg)
    dt, Bv, Cv = (xin @ m.w("x_proj", dt_)).split([dtr, ds, ds], dim=-1)
    dt = F.softplus(dt @ m.w("dt_proj", dt_) + m.w("dt_bias", dt_))
    # on a mesh: the scan's inputs with d_inner over "model" (the
    # reference's hint)
    dt = maybe_constrain(dt, (DATA, None, "model"))
    xin = maybe_constrain(xin, (DATA, None, "model"))
    A = -torch.exp(m.A_log.float())

    if h0 is None:
        h0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    Cf = Cv.float()
    if S == 1:
        a1 = torch.exp(dt.float()[:, 0, :, None] * A)
        u1 = (dt * xin).float()[:, 0, :, None] * Bv.float()[:, 0, None, :]
        h_last = a1 * h0 + u1
        y = torch.einsum("bdn,bn->bd", h_last, Cf[:, 0])[:, None]
    else:
        y, h_last = _scan_on_blocks(dt, xin, Bv, Cf, A, h0,
                                    min(cfg.scan_chunk, S))
    y = y.to(dt_) + xin * m.w("D", dt_)
    y = y * F.silu(z)
    return res + y @ m.w("out_proj", dt_), (new_conv, h_last)


def init_mamba_state(cfg: ArchConfig, batch: int, device) -> tuple:
    """A zero (conv_state (B, dc-1, di) in the compute type, h (B, di, ds)
    float32)."""
    di, ds, dc = d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    return (torch.zeros((batch, dc - 1, di), dtype=cfg.compute_dtype,
                        device=device),
            torch.zeros((batch, di, ds), dtype=torch.float32, device=device))


__all__ = ["Mamba", "causal_conv", "d_inner", "dt_rank", "init_mamba_params",
           "init_mamba_state", "mamba_fwd", "selective_scan"]
