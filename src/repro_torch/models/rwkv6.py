"""RWKV-6 "Finch" — attention-free LM with data-dependent decay.

The port of ``repro/models/rwkv6.py``.  Per layer: time-mix (the WKV
linear-attention recurrence) + channel-mix.  The WKV recurrence per head
(state S in R^{hd x hd}):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with per-channel decay w_t in (0,1) produced from the input via a LoRA.
A multi-token time-mix goes through ``kernels/rwkv6::wkv6`` (K3: the
hand-written kernel on a CUDA tensor, the plain chunked version on a CPU
tensor); a single-token decode step is one recurrence step in plain torch,
as in the reference.

Each layer is an :class:`RWKV6Layer` module holding the reference's
per-layer parameters under the reference's names, matrices in its ``(in,
out)`` orientation (used as ``x @ W``).  Parameters live in
``cfg.param_dtype``; matrices are cast to the compute type at use, as in
the reference.  The cast of a matrix is computed once and kept (the same
values as casting at every use) until the parameter is changed or moved;
the inference entry points :func:`prefill` and :func:`decode_step` run
without autograd (under autograd every use casts anew, see ``CastCache``).
Training (:func:`forward_hidden`, :func:`loss_fn`, the reference's) runs
each layer under ``remat_wrap(cfg.remat)``, the scan through ``wkv6``'s
autograd route (K3 forward, K3' backward, on CUDA); the head is the untied
``lm_head``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6 import wkv6
from .common import (DATA, ArchConfig, CastCache, cross_entropy,
                     dense_init, embed_init, lay_out, lookup, maybe_constrain,
                     nest_layers, remat_wrap, rms_norm)

LORA_RANK = 32

#: per-layer parameters of the reference: (d,) vectors, and matrices by
#: shape(d, ff)
_VECTORS = ("ln1", "ln2", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g", "w0", "u",
            "gn_scale", "mu_ck", "mu_cr")
_MATRICES = {
    "w_lora_a": lambda d, ff: (d, LORA_RANK),
    "w_lora_b": lambda d, ff: (LORA_RANK, d),
    "wr": lambda d, ff: (d, d), "wk": lambda d, ff: (d, d),
    "wv": lambda d, ff: (d, d), "wg": lambda d, ff: (d, d),
    "wo": lambda d, ff: (d, d),
    "ck": lambda d, ff: (d, ff), "cv": lambda d, ff: (ff, d),
    "cr": lambda d, ff: (d, d),
}
#: the reference's initial values of the vectors
_VECTOR_INIT = {"ln1": 1.0, "ln2": 1.0, "gn_scale": 1.0, "w0": -6.0,
                "u": 0.0, "mu_w": 0.5, "mu_k": 0.5, "mu_v": 0.5, "mu_r": 0.5,
                "mu_g": 0.5, "mu_ck": 0.5, "mu_cr": 0.5}


def num_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def _step(rf, kf, vf, lw, u, S0) -> tuple:
    """One decode step of the recurrence: r, k, v, log w (B, H, hd), u (H,
    hd), the state S0 (B, H, hd, hd) -> (y (B, H, hd), the new state)."""
    y = torch.einsum("bhk,bhkv->bhv", rf, S0) + \
        torch.einsum("bhk,bhk->bh", rf, u[None] * kf)[..., None] * vf
    S_new = torch.exp(lw)[..., None] * S0 + \
        torch.einsum("bhk,bhv->bhkv", kf, vf)
    return y, S_new


def _step_on_blocks(rf, kf, vf, lw, u, S0) -> tuple:
    """:func:`_step`, on DTensors (the dry run's sharded decode) each
    rank's block of the batch and the heads through ``local_map``, laid out
    as the state is (a product over two split dims flattened is not
    planned by every torch release's DTensor); on plain tensors as it
    is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(S0, DTensor):
        return _step(rf, kf, vf, lw, u, S0)
    from torch.distributed.tensor.experimental import local_map
    mesh = S0.device_mesh
    x_pl = [p if p in (Shard(0), Shard(1)) else Replicate()
            for p in S0.placements]
    u_pl = [Shard(0) if p == Shard(1) else Replicate() for p in x_pl]
    args = [lay_out(t, mesh, x_pl) for t in (rf, kf, vf, lw)] + [
        lay_out(u, mesh, u_pl), lay_out(S0, mesh, x_pl)]
    return local_map(_step, out_placements=(x_pl, x_pl),
                     in_placements=(x_pl,) * 4 + (u_pl, x_pl),
                     device_mesh=mesh)(*args)


def wkv_chunk(cfg: ArchConfig, S: int) -> int:
    """The reference's chunk for an S-token scan: ``scan_chunk`` capped at
    S, halved until it divides S."""
    chunk = min(cfg.scan_chunk, S)
    while S % chunk != 0:
        chunk //= 2
    return max(chunk, 1)


def _token_shift(x, prev):
    """(B, S, d) -> previous-token tensor; ``prev``: (B, 1, d) carry."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _heads(x, hd):
    B, S, d = x.shape
    return x.reshape(B, S, d // hd, hd)


class RWKV6Layer(nn.Module):
    """One RWKV6 block: ``time_mix``, ``channel_mix`` and ``forward`` (the
    reference's ``block_fwd``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        for name in _VECTORS:
            self.register_parameter(name, nn.Parameter(torch.empty(
                d, dtype=cfg.param_dtype, device=device)))
        for name, shape in _MATRICES.items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape(d, ff), dtype=cfg.param_dtype, device=device)))
        self._cast = CastCache()

    def w(self, name: str, dtype) -> torch.Tensor:
        """Parameter ``name`` in ``dtype``."""
        return self._cast.get(name, getattr(self, name), dtype)

    def time_mix(self, x, *, shift_state=None, wkv_state=None):
        """Returns (y, (new_shift, new_wkv))."""
        cfg = self.cfg
        B, S, d = x.shape
        hd = cfg.rwkv_head_dim
        H = d // hd
        dt = x.dtype
        prev = shift_state if shift_state is not None else \
            x.new_zeros((B, 1, d))
        xx = _token_shift(x, prev)

        def mixed(name):
            return x + (xx - x) * self.w(f"mu_{name}", dt)

        xw, xk, xv, xr, xg = (mixed(n) for n in ("w", "k", "v", "r", "g"))
        r = _heads(xr @ self.w("wr", dt), hd)
        k = _heads(xk @ self.w("wk", dt), hd)
        v = _heads(xv @ self.w("wv", dt), hd)
        g = xg @ self.w("wg", dt)

        # data-dependent decay (the RWKV6 LoRA): w in (0,1), logw <= 0
        lora = torch.tanh(xw @ self.w("w_lora_a", dt)) @ \
            self.w("w_lora_b", dt)
        logw = -torch.exp(self.w0.float() + lora.float())
        logw = _heads(logw, hd)
        u = self.u.float().reshape(H, hd)

        S0 = wkv_state if wkv_state is not None else \
            torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        if S == 1:
            # decode: one recurrence step, plain torch
            rf, kf, vf = (t[:, 0].float() for t in (r, k, v))
            y, S_new = _step_on_blocks(rf, kf, vf, logw[:, 0].float(), u,
                                       S0)
            y = y[:, None]
        else:
            y, S_new = wkv6(r, k, v, logw, u, S0, chunk=wkv_chunk(cfg, S))

        # per-head group norm (population variance, as jnp.var)
        y = y.reshape(B, S, H, hd)
        y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
            y.var(-1, keepdim=True, correction=0) + 64e-5)
        y = y.reshape(B, S, d) * self.gn_scale.float()
        y = y.to(dt) * F.silu(g)
        out = y @ self.w("wo", dt)
        return out, (x[:, -1:], S_new)

    def channel_mix(self, x, *, shift_state=None):
        B, S, d = x.shape
        dt = x.dtype
        prev = shift_state if shift_state is not None else \
            x.new_zeros((B, 1, d))
        xx = _token_shift(x, prev)
        xk = x + (xx - x) * self.w("mu_ck", dt)
        xr = x + (xx - x) * self.w("mu_cr", dt)
        kk = torch.square(torch.relu(xk @ self.w("ck", dt)))
        out = torch.sigmoid(xr @ self.w("cr", dt)) * (kk @ self.w("cv", dt))
        return out, x[:, -1:]

    def forward(self, x, *, state=None):
        """state: (shift_tm, wkv, shift_cm) or None.  Returns (x, state)."""
        s_tm = s_wkv = s_cm = None
        if state is not None:
            s_tm, s_wkv, s_cm = state
        eps = self.cfg.norm_eps
        h, (new_tm, new_wkv) = self.time_mix(
            rms_norm(x, self.ln1, eps), shift_state=s_tm, wkv_state=s_wkv)
        x = x + h
        h, new_cm = self.channel_mix(rms_norm(x, self.ln2, eps),
                                     shift_state=s_cm)
        x = x + h
        return x, (new_tm, new_wkv, new_cm)


class RWKV6(nn.Module):
    """The model: embedding, the layers, final norm and LM head."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        self.embed = nn.Parameter(torch.empty((cfg.vocab, d), dtype=pd,
                                              device=device))
        self.layers = nn.ModuleList(RWKV6Layer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty(d, dtype=pd,
                                                   device=device))
        self.lm_head = nn.Parameter(torch.empty((d, cfg.vocab), dtype=pd,
                                                device=device))
        self._cast = CastCache()

    def embed_tokens(self, tokens) -> torch.Tensor:
        # an embedding op, whose backward DTensor plans in every torch
        # release (an index's, a scatter into zeros of the table, not in
        # all); on a mesh the rows over the data axes
        x = F.embedding(tokens.long(), self.embed).to(self.cfg.compute_dtype)
        return maybe_constrain(x, (DATA, None, None))

    def logits(self, x) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self._cast.get("lm_head", self.lm_head, x.dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> RWKV6:
    """The reference's initializer on ``device``, drawn from ``generator``
    (which must live on that device).  ``jax.random`` streams cannot be
    reproduced in torch; to start from the reference's own weights use
    :func:`params_from_jax`."""
    model = RWKV6(cfg, device)
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    with torch.no_grad():
        model.embed.copy_(embed_init(generator, (cfg.vocab, d), pd, device))
        for layer in model.layers:
            for name, value in _VECTOR_INIT.items():
                getattr(layer, name).fill_(value)
            for name, shape in _MATRICES.items():
                getattr(layer, name).copy_(
                    dense_init(generator, shape(d, ff), pd, device))
        model.final_norm.fill_(1.0)
        model.lm_head.copy_(dense_init(generator, (d, cfg.vocab), pd,
                                       device))
    return model


def params_from_jax(tree, cfg: ArchConfig, device) -> RWKV6:
    """Carry the reference's ``init_params`` tree (numpy arrays; per-layer
    parameters stacked on a leading ``L`` axis) into a model on
    ``device``, in ``cfg.param_dtype``."""
    model = RWKV6(cfg, device)

    def put(p, a):
        p.copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))

    with torch.no_grad():
        for name, p in model.named_parameters():
            put(p, lookup(tree, name))
    return model


def params_to_jax(model: RWKV6) -> dict:
    """The inverse of :func:`params_from_jax`: the reference's tree, as
    float32 numpy arrays."""
    return nest_layers({n: p.detach().float().cpu().numpy()
                        for n, p in model.named_parameters()}, np.stack)


def init_state(cfg: ArchConfig, batch: int, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    L = cfg.num_layers
    return {
        "shift_tm": torch.zeros((L, batch, 1, d), dtype=cfg.compute_dtype,
                                device=device),
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_cm": torch.zeros((L, batch, 1, d), dtype=cfg.compute_dtype,
                                device=device),
    }


def _stack_states(states) -> dict:
    tm, wkv, cm = zip(*states)
    return {"shift_tm": torch.stack(tm), "wkv": torch.stack(wkv),
            "shift_cm": torch.stack(cm)}


def _layer_train(layer, x):
    return layer(x)[0]


def forward_hidden(model: RWKV6, tokens) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, d), every layer under
    ``remat_wrap(cfg.remat)``; differentiable (the training forward)."""
    x = model.embed_tokens(tokens)
    for layer in model.layers:
        x = remat_wrap(functools.partial(_layer_train, layer),
                       model.cfg.remat)(x)
    return x


def loss_fn(model: RWKV6, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({tokens, labels}, (B, S)
    each, tensors or arrays) — the reference's ``loss_fn``."""
    dev = model.embed.device
    x = forward_hidden(model, torch.as_tensor(batch["tokens"], device=dev))
    return cross_entropy(model.logits(x),
                         torch.as_tensor(batch["labels"], device=dev))


@torch.no_grad()
def prefill(model: RWKV6, tokens, cache_len: int = 0):
    """Returns (last logits (B, 1, V), state).  ``cache_len`` is unused:
    the state is O(1) in the sequence length."""
    x = model.embed_tokens(tokens)
    states = []
    for layer in model.layers:
        x, st = layer(x)
        states.append(st)
    return model.logits(x[:, -1:]), _stack_states(states)


@torch.no_grad()
def decode_step(model: RWKV6, state: dict, token, pos=None):
    """One token (B, 1) through every layer; returns (logits, state)."""
    x = model.embed_tokens(token)
    states = []
    for i, layer in enumerate(model.layers):
        x, st = layer(x, state=(state["shift_tm"][i], state["wkv"][i],
                                state["shift_cm"][i]))
        states.append(st)
    return model.logits(x), _stack_states(states)


__all__ = ["LORA_RANK", "RWKV6", "RWKV6Layer", "decode_step",
           "forward_hidden", "init_params", "init_state", "loss_fn",
           "num_heads", "params_from_jax", "params_to_jax", "prefill",
           "wkv_chunk"]
