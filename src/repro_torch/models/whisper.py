"""Whisper-style encoder-decoder (audio backbone, conv front end stubbed) —
the port of ``repro/models/whisper.py`` (``whisper-small``).

As in the reference, the modality front end is a stub: the encoder takes
precomputed frame embeddings (B, T_enc, d) where the two conv layers would
produce them.  The backbone: pre-LN LayerNorm with bias (eps 1e-5), GELU
MLPs with biases, sinusoidal positions in the encoder and learned ones in
the decoder (``(pos0 + arange(S)) % 448``), bidirectional encoder
self-attention, and a decoder with causal self-attention and
cross-attention into the encoder's output; the head is the token
embedding transposed.  The reference's asymmetries are kept: ``wk`` /
``x_wk`` have no bias, ``wq`` / ``wv`` / ``wo`` (and their ``x_``
counterparts) do.

Every attention over a whole sequence goes through
``kernels/flash::flash_attention`` (K2; K2' for its gradient): the
encoder's without the causal mask (T_enc x T_enc), the decoder's
self-attention with it, and the cross-attention without it (S queries
against T_enc keys); on a mesh, laid out by
``transformer.py::attention_layout``: where the heads do not divide the
"model" axis, the keys' sequence splits over it, as the reference's
``_kv_seq_spec`` (``repro/models/whisper.py:96-105, 194-202``).  A decode step attends through the plain
``decode_attention``: over the self-attention cache, and over every frame
of the cross cache (the reference's ``pos`` = T_enc - 1).  The cache is
the reference's: ``k`` / ``v`` (L, B, T, H, hd) and the cross ``xk`` /
``xv`` (L, B, T_enc, H, hd), computed once by the prefill, in the compute
type; a decode step updates ``k`` / ``v`` in place.

Parameters: ``tok_embed``, ``dec_pos``, ``enc_layers.<i>.<name>``,
``dec_layers.<i>.<name>``, ``enc_ln`` and ``dec_ln`` (each LayerNorm a
``scale`` and a ``bias``), mapping to the reference's tree with each
layer's parameters stacked over the layers (:func:`params_from_jax`,
:func:`params_to_jax`).  Training runs each layer under
``remat_wrap(cfg.remat)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from ..kernels.flash import flash_attention
from .common import (ArchConfig, CastCache, cross_entropy, decode_attention,
                     dense_init, embed_init, gelu_mlp, head_input,
                     heads_flat, layer_norm, lookup, maybe_constrain,
                     mesh_zeros, nest_layers, remat_wrap)
from .transformer import attention_layout

MAX_TARGET_POSITIONS = 448
LN_EPS = 1e-5


def _attn_names(prefix: str = "") -> tuple:
    return tuple(prefix + n for n in ("wq", "bq", "wk", "wv", "bv", "wo",
                                      "bo"))


class LayerNorm(nn.Module):
    """A LayerNorm's ``scale`` and ``bias`` (d,)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, pd = cfg.d_model, cfg.param_dtype
        self.scale = nn.Parameter(torch.empty(d, dtype=pd, device=device))
        self.bias = nn.Parameter(torch.empty(d, dtype=pd, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, LN_EPS)


class WhisperLayer(nn.Module):
    """An encoder layer (``ln1``, self-attention, ``ln2``, MLP) or, with
    ``cross``, a decoder layer (also ``ln_x`` and the ``x_``
    cross-attention)."""

    def __init__(self, cfg: ArchConfig, cross: bool, device=None):
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        self.ln1 = LayerNorm(cfg, device)
        if cross:
            self.ln_x = LayerNorm(cfg, device)
        self.ln2 = LayerNorm(cfg, device)
        for prefix in ("", "x_") if cross else ("",):
            for name in _attn_names(prefix):
                shape = (d, d) if name[len(prefix)] == "w" else (d,)
                self.register_parameter(name, nn.Parameter(torch.empty(
                    shape, dtype=cfg.param_dtype, device=device)))
        for name, shape in (("w_up", (d, ff)), ("b_up", (ff,)),
                            ("w_down", (ff, d)), ("b_down", (d,))):
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=cfg.param_dtype, device=device)))
        self._cast = CastCache()

    def w(self, name: str, dtype) -> torch.Tensor:
        return self._cast.get(name, getattr(self, name), dtype)

    def heads(self, x) -> torch.Tensor:
        B, S, _ = x.shape
        x = heads_flat(x, self.cfg.n_heads)
        return x.reshape(B, S, self.cfg.n_heads, self.cfg.head_dim)

    def query(self, h, prefix: str = "") -> torch.Tensor:
        dt = h.dtype
        return self.heads(h @ self.w(prefix + "wq", dt)
                          + self.w(prefix + "bq", dt))

    def keys_values(self, h, prefix: str = "") -> tuple:
        dt = h.dtype
        return (self.heads(h @ self.w(prefix + "wk", dt)),
                self.heads(h @ self.w(prefix + "wv", dt)
                           + self.w(prefix + "bv", dt)))

    def out(self, o, prefix: str = "") -> torch.Tensor:
        B, S = o.shape[:2]
        dt = o.dtype
        o = heads_flat(o.reshape(B, S, self.cfg.d_model), self.cfg.n_heads)
        return o @ self.w(prefix + "wo", dt) + self.w(prefix + "bo", dt)

    def mlp(self, h) -> torch.Tensor:
        return gelu_mlp(h, *(self.w(n, h.dtype) for n in
                             ("w_up", "b_up", "w_down", "b_down")))


class Whisper(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        self.tok_embed = nn.Parameter(torch.empty((cfg.vocab, d), dtype=pd,
                                                  device=device))
        self.dec_pos = nn.Parameter(torch.empty((MAX_TARGET_POSITIONS, d),
                                                dtype=pd, device=device))
        self.enc_layers = nn.ModuleList(WhisperLayer(cfg, False, device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(WhisperLayer(cfg, True, device)
                                        for _ in range(cfg.num_layers))
        self.enc_ln = LayerNorm(cfg, device)
        self.dec_ln = LayerNorm(cfg, device)
        self._cast = CastCache()

    def embed_tokens(self, tokens, pos0: int = 0) -> torch.Tensor:
        """Token embeddings plus the learned positions ``(pos0 +
        arange(S)) % 448``, in the compute type."""
        ct = self.cfg.compute_dtype
        x = self.tok_embed[tokens.long()].to(ct)
        pos = (pos0 + torch.arange(tokens.shape[1], device=x.device)) \
            % MAX_TARGET_POSITIONS
        return x + self.dec_pos[pos].to(ct)[None]

    def logits(self, x) -> torch.Tensor:
        # on a mesh, the vocab (or where it does not split, the tokens)
        # over "model", as transformer.py's head
        x, spec = head_input(self.dec_ln(x), self.cfg.vocab)
        return maybe_constrain(
            x @ self._cast.get("tok_embed", self.tok_embed, x.dtype).T, spec)


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) float32: sin then cos of position x
    exp(-log(10000) / (channels / 2 - 1) x i)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Whisper:
    """The reference's initializer on ``device``, drawn from ``generator``
    (which must live on that device): LayerNorm scales one and biases
    zero, matrices a truncated normal over sqrt(fan_in), the embeddings
    normal at 0.02.  To start from the reference's own weights use
    :func:`params_from_jax`."""
    model = Whisper(cfg, device)
    pd = cfg.param_dtype
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.split(".")[-1]
            if name in ("tok_embed", "dec_pos"):
                p.copy_(embed_init(generator, tuple(p.shape), pd, device))
            elif leaf == "scale":
                p.fill_(1.0)
            elif p.dim() == 2:
                p.copy_(dense_init(generator, tuple(p.shape), pd, device))
            else:
                p.zero_()
    return model


def params_from_jax(tree, cfg: ArchConfig, device) -> Whisper:
    """Carry the reference's ``init_params`` tree (numpy arrays; each
    layer's parameters stacked over ``enc_layers`` / ``dec_layers``) into a
    model on ``device``."""
    model = Whisper(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(
                lookup(tree, name), np.float32)))
    return model


def params_to_jax(model: Whisper) -> dict:
    """The inverse of :func:`params_from_jax`: the reference's tree, as
    float32 numpy arrays."""
    return nest_layers({n: p.detach().float().cpu().numpy()
                        for n, p in model.named_parameters()}, np.stack)


def _enc_layer(layer, x):
    h = layer.ln1(x)
    k, v = layer.keys_values(h)
    x = x + layer.out(flash_attention(
        *attention_layout(layer.query(h), k, v), causal=False))
    return x + layer.mlp(layer.ln2(x))


def encode(model: Whisper, frames) -> torch.Tensor:
    """frames (B, T_enc, d), the stubbed front end's output -> the
    encoder's output (B, T_enc, d) in the compute type."""
    cfg = model.cfg
    x = torch.as_tensor(frames, device=model.tok_embed.device).to(
        cfg.compute_dtype)
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    for layer in model.enc_layers:
        x = remat_wrap(functools.partial(_enc_layer, layer), cfg.remat)(x)
    return model.enc_ln(x)


def _dec_layer(layer, x, enc_out, xk=None, xv=None):
    """A decoder layer from position 0: returns (x, (k, v)); the cross
    keys and values are computed from ``enc_out`` unless given."""
    h = layer.ln1(x)
    k, v = layer.keys_values(h)
    x = x + layer.out(flash_attention(
        *attention_layout(layer.query(h), k, v), causal=True))
    h = layer.ln_x(x)
    if xk is None:
        xk, xv = layer.keys_values(enc_out, "x_")
    o = flash_attention(*attention_layout(layer.query(h, "x_"), xk, xv),
                        causal=False)
    x = x + layer.out(o, "x_")
    return x + layer.mlp(layer.ln2(x)), (k, v)


def _dec_layer_train(layer, x, enc_out):
    return _dec_layer(layer, x, enc_out)[0]


def decode_train(model: Whisper, tokens, enc_out) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) against the encoder's output
    -> logits (B, S, V), each layer under ``remat_wrap(cfg.remat)``."""
    x = model.embed_tokens(tokens)
    for layer in model.dec_layers:
        x = remat_wrap(functools.partial(_dec_layer_train, layer),
                       model.cfg.remat)(x, enc_out)
    return model.logits(x)


def loss_fn(model: Whisper, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({frames (B, T_enc, d),
    tokens, labels (B, S)}, tensors or arrays) — the reference's
    ``loss_fn``."""
    dev = model.tok_embed.device
    enc_out = encode(model, batch["frames"])
    logits = decode_train(model, torch.as_tensor(batch["tokens"],
                                                 device=dev), enc_out)
    return cross_entropy(logits, torch.as_tensor(batch["labels"],
                                                 device=dev))


def make_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """The zeroed cache: ``k`` / ``v`` (L, B, cache_len, H, hd) and ``xk``
    / ``xv`` (L, B, ``encoder_frames``, H, hd), in the compute type."""
    L, H, hd = cfg.num_layers, cfg.n_heads, cfg.head_dim
    ct = cfg.compute_dtype
    shape = (L, batch, cache_len, H, hd)
    xshape = (L, batch, cfg.encoder_frames, H, hd)
    return {"k": torch.zeros(shape, dtype=ct, device=device),
            "v": torch.zeros(shape, dtype=ct, device=device),
            "xk": torch.zeros(xshape, dtype=ct, device=device),
            "xv": torch.zeros(xshape, dtype=ct, device=device)}


@torch.no_grad()
def prefill(model: Whisper, frames, tokens, cache_len: int) -> tuple:
    """The encoder over ``frames``, then the decoder over the prompt
    ``tokens`` (B, S) from position 0; returns (last-position logits (B,
    1, V), cache), the cross keys and values over the frames given."""
    enc_out = encode(model, frames)
    x = model.embed_tokens(tokens)
    B, S = x.shape[:2]
    if S > cache_len:
        raise ValueError(f"a {S}-token prompt does not fit a cache of "
                         f"{cache_len}")
    spec = make_cache(model.cfg, B, cache_len, "meta")
    cache = None
    cross = []
    for i, layer in enumerate(model.dec_layers):
        xk, xv = layer.keys_values(enc_out, "x_")
        x, (k, v) = _dec_layer(layer, x, enc_out, xk, xv)
        if cache is None:
            # laid out as the keys (a plain tensor on their device)
            cache = {n: mesh_zeros(spec[n], k) for n in ("k", "v")}
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cross.append((xk, xv))
    cache["xk"] = torch.stack([xk for xk, _ in cross])
    cache["xv"] = torch.stack([xv for _, xv in cross])
    return model.logits(x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: Whisper, cache: dict, token, pos: int) -> tuple:
    """One token (B, 1) at position ``pos`` through every decoder layer;
    returns (logits, cache), ``k`` / ``v`` updated in place (the returned
    dict is ``cache``)."""
    x = model.embed_tokens(token, pos)
    for i, layer in enumerate(model.dec_layers):
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = layer.ln1(x)
        k, v = layer.keys_values(h)
        at = min(pos, k_cache.shape[1] - 1)    # the reference's clamp
        k_cache[:, at:at + 1] = k
        v_cache[:, at:at + 1] = v
        x = x + layer.out(decode_attention(layer.query(h), k_cache, v_cache,
                                           pos))
        xk, xv = cache["xk"][i], cache["xv"][i]
        o = decode_attention(layer.query(layer.ln_x(x), "x_"), xk, xv,
                             xk.shape[1] - 1)
        x = x + layer.out(o, "x_")
        x = x + layer.mlp(layer.ln2(x))
    return model.logits(x), cache


__all__ = ["MAX_TARGET_POSITIONS", "Whisper", "WhisperLayer", "decode_step",
           "decode_train", "encode", "init_params", "loss_fn", "make_cache",
           "params_from_jax", "params_to_jax", "prefill", "sinusoids"]
