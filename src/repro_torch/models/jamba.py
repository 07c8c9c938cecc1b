"""Jamba-style hybrid: Mamba + attention (one in ``attn_every``) + MoE —
the port of ``repro/models/jamba.py`` (``jamba-1.5-large-398b``).

Layer i:  mixer = attention   if i % attn_every == attn_every - 1 else Mamba
          ffn   = MoE         if i % moe_every == moe_every - 1  else SwiGLU

The stack is a sequence of *periods* of ``attn_every`` layers (Jamba-1.5:
72 layers = 9 periods of 8).  Each slot of a period is a :class:`Slot`
module holding the reference's parameters under its names: the attention
mixer's ``ln1``, ``wq`` / ``wk`` / ``wv`` / ``wo`` (no RoPE: Mamba gives the
order) or the ``mamba`` block (``models/mamba.py``), then ``ln2`` and the
SwiGLU's ``w_gate`` / ``w_up`` / ``w_down`` or the ``moe`` experts
(``models/moe.py``).  Named ``periods.<p>.slot<j>.<name>``, they map to the
reference's ``periods/slot<j>/...`` tree, stacked over the periods
(:func:`params_from_jax`, :func:`params_to_jax`).

The attention of a prefill or a training step goes through
``kernels/flash::flash_attention`` (K2; K2' for its gradient), causal, K
and V not repeated per query head; a decode step attends through the plain
``decode_attention`` over the whole cache, as in the reference.  The cache
is the reference's: per period ``k`` / ``v`` (P, B, T, KV, hd) and each
Mamba slot's ``m{j}_conv`` (P, B, dc-1, di) in the compute type and
``m{j}_h`` (P, B, di, ds) in float32; a decode step updates it in place.

Training runs each period under ``remat_wrap(cfg.remat)`` and, unless
``remat`` is ``"none"``, each slot's Mamba block and FFN under a
checkpoint of its own as well (the reference's per-slot remat, which
bounds the backward's residuals to one layer at a time).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash import flash_attention
from . import mamba as mamba_lib
from . import moe as moe_lib
from .common import (ArchConfig, CastCache, cross_entropy, decode_attention,
                     dense_init, embed_init, lookup, mesh_zeros, nest_layers,
                     remat_wrap, rms_norm)
from .transformer import project_qkv


def num_periods(cfg: ArchConfig) -> int:
    if cfg.attn_every <= 0 or cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers are not whole periods of "
                         f"attn_every {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def _slot_kinds(cfg: ArchConfig) -> list:
    """[(mixer, ffn)] for the ``attn_every`` slots of one period."""
    kinds = []
    for j in range(cfg.attn_every):
        mixer = "attn" if j == cfg.attn_every - 1 else "mamba"
        ffn = "moe" if (j % cfg.moe_every) == (cfg.moe_every - 1) else "mlp"
        kinds.append((mixer, ffn))
    return kinds


def _slot_shapes(cfg: ArchConfig, mixer: str, ffn: str) -> dict:
    """The slot's own parameters (besides ``mamba`` and ``moe``) by shape,
    with the fill each starts from ("one", "zero" or "dense")."""
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    H, KV = cfg.n_heads, cfg.n_kv
    out = {}
    if mixer == "attn":
        out["ln1"] = ((d,), "one")
        out.update(wq=((d, H * hd), "dense"), wk=((d, KV * hd), "dense"),
                   wv=((d, KV * hd), "dense"), wo=((H * hd, d), "dense"))
        if cfg.qkv_bias:
            out.update(bq=((H * hd,), "zero"), bk=((KV * hd,), "zero"),
                       bv=((KV * hd,), "zero"))
        if cfg.qk_norm:
            out.update(q_norm=((hd,), "one"), k_norm=((hd,), "one"))
    out["ln2"] = ((d,), "one")
    if ffn == "mlp":
        out.update(w_gate=((d, ff), "dense"), w_up=((d, ff), "dense"),
                   w_down=((ff, d), "dense"))
    return out


class Slot(nn.Module):
    """One layer of a period: its mixer (attention or Mamba) and its FFN
    (SwiGLU or MoE)."""

    def __init__(self, cfg: ArchConfig, mixer: str, ffn: str, device=None):
        super().__init__()
        self.cfg, self.mixer, self.ffn = cfg, mixer, ffn
        for name, (shape, _) in _slot_shapes(cfg, mixer, ffn).items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=cfg.param_dtype, device=device)))
        if mixer == "mamba":
            self.mamba = mamba_lib.Mamba(cfg, device)
        if ffn == "moe":
            self.moe = moe_lib.MoEFFN(cfg, device)
        self._cast = CastCache()

    def w(self, name: str, dtype) -> torch.Tensor:
        return self._cast.get(name, getattr(self, name), dtype)

    def attend(self, x, cache=None, pos=None):
        """The attention mixer (the reference's ``_attn_mixer``).  Without
        ``cache`` (from position 0): returns (x, (k, v)).  With ``cache`` =
        (k_cache, v_cache) (B, T, KV, hd) and S == 1: writes k and v at
        ``min(pos, T - 1)`` in place (the reference's clamp) and returns
        (x, cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = project_qkv(self, rms_norm(x, self.ln1, cfg.norm_eps))
        if cache is None:
            attn = flash_attention(q, k, v, causal=True)
            new = (k, v)
        else:
            k_cache, v_cache = cache
            at = min(pos, k_cache.shape[1] - 1)
            k_cache[:, at:at + 1] = k
            v_cache[:, at:at + 1] = v
            attn = decode_attention(q, k_cache, v_cache, pos)
            new = cache
        attn = attn.reshape(B, S, cfg.n_heads * cfg.head_dim)
        return x + attn @ self.w("wo", x.dtype), new

    def feed_forward(self, x):
        """x + FFN(rms_norm(x)) (the reference's ``_ffn``)."""
        h = rms_norm(x, self.ln2, self.cfg.norm_eps)
        if self.ffn == "moe":
            return x + self.moe(h)
        dt = h.dtype
        y = F.silu(h @ self.w("w_gate", dt)) * (h @ self.w("w_up", dt))
        return x + y @ self.w("w_down", dt)


class Jamba(nn.Module):
    """The model: ``embed``, the periods (``periods.<p>.slot<j>``),
    ``final_norm`` and an untied ``lm_head`` (d, vocab)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        kinds = _slot_kinds(cfg)
        self.embed = nn.Parameter(torch.empty((cfg.vocab, d), dtype=pd,
                                              device=device))
        self.periods = nn.ModuleList(
            nn.ModuleDict({f"slot{j}": Slot(cfg, mixer, ffn, device)
                           for j, (mixer, ffn) in enumerate(kinds)})
            for _ in range(num_periods(cfg)))
        self.final_norm = nn.Parameter(torch.empty(d, dtype=pd,
                                                   device=device))
        self.lm_head = nn.Parameter(torch.empty((d, cfg.vocab), dtype=pd,
                                                device=device))
        self._cast = CastCache()

    def embed_tokens(self, tokens) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.cfg.compute_dtype)

    def logits(self, x) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self._cast.get("lm_head", self.lm_head, x.dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Jamba:
    """The reference's initializer on ``device``, drawn from ``generator``
    (which must live on that device): norms one, biases zero, matrices a
    truncated normal over sqrt(fan_in), the embedding normal at 0.02.  To
    start from the reference's own weights use :func:`params_from_jax`."""
    model = Jamba(cfg, device)
    pd = cfg.param_dtype
    with torch.no_grad():
        model.embed.copy_(embed_init(generator, (cfg.vocab, cfg.d_model), pd,
                                     device))
        for period in model.periods:
            for slot in period.values():
                for name, (shape, fill) in _slot_shapes(
                        cfg, slot.mixer, slot.ffn).items():
                    p = getattr(slot, name)
                    if fill == "dense":
                        p.copy_(dense_init(generator, shape, pd, device))
                    else:
                        p.fill_(1.0 if fill == "one" else 0.0)
                if slot.mixer == "mamba":
                    mamba_lib.init_mamba_params(slot.mamba, generator)
                if slot.ffn == "moe":
                    moe_lib.init_moe_params(slot.moe, generator)
        model.final_norm.fill_(1.0)
        model.lm_head.copy_(dense_init(generator, (cfg.d_model, cfg.vocab),
                                       pd, device))
    return model


def params_from_jax(tree, cfg: ArchConfig, device) -> Jamba:
    """Carry the reference's ``init_params`` tree (numpy arrays; each
    slot's parameters stacked over the periods under
    ``periods/slot<j>``) into a model on ``device``."""
    model = Jamba(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(
                lookup(tree, name), np.float32)))
    return model


def params_to_jax(model: Jamba) -> dict:
    """The inverse of :func:`params_from_jax`: the reference's tree, as
    float32 numpy arrays."""
    return nest_layers({n: p.detach().float().cpu().numpy()
                        for n, p in model.named_parameters()}, np.stack)


def period_fwd(period, x, cfg: ArchConfig, *, mode: str = "train",
               caches=None, pos=None) -> tuple:
    """Run one period (``attn_every`` slots) in ``mode`` "train",
    "prefill" (both from position 0) or "decode" (S == 1 at ``pos``).
    ``caches`` (decode): {'kv': (k_cache, v_cache), 'mamba<j>': (conv, h)};
    returns (x, the new caches in that layout)."""
    new_caches = {}
    inner_remat = mode == "train" and cfg.remat != "none"
    for j, slot in enumerate(period.values()):
        if slot.mixer == "attn":
            cache = caches.get("kv") if caches else None
            x, new_caches["kv"] = slot.attend(x, cache, pos)
        elif inner_remat:
            x = remat_wrap(lambda xx, m=slot.mamba: mamba_lib.mamba_fwd(
                m, xx)[0], "layer")(x)
        else:
            state = caches.get(f"mamba{j}") if caches else None
            x, new_caches[f"mamba{j}"] = mamba_lib.mamba_fwd(
                slot.mamba, x, state=state)
        if inner_remat:
            x = remat_wrap(slot.feed_forward, "layer")(x)
        else:
            x = slot.feed_forward(x)
    return x, new_caches


def _period_train(period, cfg, x):
    return period_fwd(period, x, cfg, mode="train")[0]


def forward_hidden(model: Jamba, tokens) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, d), each period under
    ``remat_wrap(cfg.remat)``; differentiable (the training forward)."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    for period in model.periods:
        x = remat_wrap(functools.partial(_period_train, period, cfg),
                       cfg.remat)(x)
    return x


def loss_fn(model: Jamba, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({tokens, labels}, (B,
    S) each, tensors or arrays) — the reference's ``loss_fn``."""
    dev = model.embed.device
    x = forward_hidden(model, torch.as_tensor(batch["tokens"], device=dev))
    return cross_entropy(model.logits(x),
                         torch.as_tensor(batch["labels"], device=dev))


def make_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """The zeroed cache in the reference's layout (see the module
    docstring)."""
    P = num_periods(cfg)
    di, ds, dc = mamba_lib.d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    ct = cfg.compute_dtype
    kv = (P, batch, cache_len, cfg.n_kv, cfg.head_dim)
    cache = {"k": torch.zeros(kv, dtype=ct, device=device),
             "v": torch.zeros(kv, dtype=ct, device=device)}
    for j, (mixer, _) in enumerate(_slot_kinds(cfg)):
        if mixer == "mamba":
            cache[f"m{j}_conv"] = torch.zeros((P, batch, dc - 1, di),
                                              dtype=ct, device=device)
            cache[f"m{j}_h"] = torch.zeros((P, batch, di, ds),
                                           dtype=torch.float32, device=device)
    return cache


def _store_states(cache: dict, p: int, new: dict) -> None:
    """Write period ``p``'s new Mamba states into the cache."""
    for key, (conv, h) in new.items():
        if key.startswith("mamba"):
            j = key[len("mamba"):]
            cache[f"m{j}_conv"][p].copy_(conv)
            cache[f"m{j}_h"][p].copy_(h)


@torch.no_grad()
def prefill(model: Jamba, tokens, cache_len: int) -> tuple:
    """Run the prompt (B, S) from position 0 and build the cache; returns
    (last-position logits (B, 1, V), cache)."""
    x = model.embed_tokens(tokens)
    B, S = x.shape[:2]
    if S > cache_len:
        raise ValueError(f"a {S}-token prompt does not fit a cache of "
                         f"{cache_len}")
    spec = make_cache(model.cfg, B, cache_len, "meta")
    cache = None
    for p, period in enumerate(model.periods):
        x, new = period_fwd(period, x, model.cfg, mode="prefill")
        k, v = new["kv"]
        if cache is None:
            # each entry laid out as what its slot takes (a plain tensor
            # on their device)
            like = {"k": k, "v": v}
            for key, (conv, h) in new.items():
                if key.startswith("mamba"):
                    j = key[len("mamba"):]
                    like[f"m{j}_conv"], like[f"m{j}_h"] = conv, h
            cache = {n: mesh_zeros(t, like[n]) for n, t in spec.items()}
        cache["k"][p, :, :S] = k
        cache["v"][p, :, :S] = v
        _store_states(cache, p, new)
    return model.logits(x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: Jamba, cache: dict, token, pos: int) -> tuple:
    """One token (B, 1) at position ``pos`` through every period; returns
    (logits, cache), the cache updated in place (the returned dict is
    ``cache``)."""
    x = model.embed_tokens(token)
    kinds = _slot_kinds(model.cfg)
    for p, period in enumerate(model.periods):
        caches = {"kv": (cache["k"][p], cache["v"][p])}
        for j, (mixer, _) in enumerate(kinds):
            if mixer == "mamba":
                caches[f"mamba{j}"] = (cache[f"m{j}_conv"][p],
                                       cache[f"m{j}_h"][p])
        x, new = period_fwd(period, x, model.cfg, mode="decode",
                            caches=caches, pos=pos)
        _store_states(cache, p, new)
    return model.logits(x), cache


__all__ = ["Jamba", "Slot", "decode_step", "forward_hidden", "init_params",
           "loss_fn", "make_cache", "num_periods", "params_from_jax",
           "params_to_jax", "period_fwd", "prefill"]
