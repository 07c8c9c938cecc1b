"""Decoder-only transformer LM — the port of
``repro/models/transformer.py``: the dense configs (``qwen3-0.6b``,
``llama3-8b``, ``qwen1.5-4b``, ``command-r-35b``), the MoE configs
(``granite-moe-3b-a800m``, ``qwen3-moe-235b-a22b``: experts in every
layer) and the LM backbone of the VLM (``internvl2-1b``, with patch
embeddings prepended by ``models/vlm.py``).

Per layer (the reference's ``block_fwd``):

    h = rms_norm(x);  q, k, v = h Wq (+ bq), h Wk (+ bk), h Wv (+ bv)
    q, k = rms_norm(q), rms_norm(k)                   (qk-norm, per head)
    q, k = rope(q), rope(k)
    x = x + attention(q, k, v) Wo
    x = x + FFN(rms_norm(x))

with the reference's options: QKV biases (``qkv_bias``, added in the
compute type before the per-head reshape), the FFN a SwiGLU
(``ffn_mult`` 3), the two-matrix GELU MLP with biases (any other
``ffn_mult``, as in the reference) or, once ``moe_experts`` > 0, the
mixture of experts of ``models/moe.py`` in every layer (a ``moe``
submodule; the reference's model, too, leaves ``moe_every`` to its
profile), and a sliding attention window (``sliding_window`` > 0).

A prefill's attention, at every prompt length, goes through
``kernels/flash::flash_attention`` (K2: the hand-written kernel on a CUDA
tensor, the plain version on a CPU tensor) with the config's window.  It
computes what the reference's ``full_attention`` (S <= ``attn_chunk``) and
``chunked_attention`` (longer prompts) compute: the prefill starts at
position 0 with as many keys as queries, so the start-aligned causal mask
is the reference's.  K2 maps each query head to its kv head itself, so K
and V are not repeated per query head.  A decode step attends through the
plain ``decode_attention`` over the whole cache, as in the reference,
which leaves the window out there too (``ROADMAP.md`` Queue 3, deliberate
differences: the port keeps the reference's behaviour).

Patch embeddings (``extra_embeds``, (B, P, d)), cast to the compute type,
are prepended to the token embeddings by :func:`forward_hidden` and
:func:`prefill`, as the reference's ``_embed`` does; :func:`loss_fn` reads
them from ``batch["patch_embeds"]`` and leaves their P positions out of
the loss.

Training (:func:`forward_hidden`, :func:`loss_fn`, the reference's
``forward_hidden`` / ``loss_fn``) runs the same layers from position 0
with grad: each layer under ``remat_wrap(cfg.remat)``, attention through
``flash_attention``'s autograd route (K2 forward, K2' backward, on CUDA).

Each layer is a :class:`TransformerLayer` module holding the reference's
per-layer parameters under the reference's names (the experts under
``moe.``), matrices in its ``(in, out)`` orientation (used as ``x @ W``).
Parameters live in ``cfg.param_dtype`` and are cast to the compute type at
use (outside autograd the cast is kept until the parameter changes, see
``CastCache``); the inference entry points :func:`prefill` and
:func:`decode_step` run without autograd.  The head is the embedding
transposed when ``tie_embeddings``, else its own ``lm_head`` of shape (d,
vocab).  ``attn_out_bias`` is carried and, as in the reference, never read.
The hybrid and audio families are built by ``models/jamba.py`` and
``models/whisper.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels.flash import flash_attention
from ..kernels.flash.split import key_blocks, split_key_local
from . import moe as moe_lib
from .common import (DATA, WHOLE, ArchConfig, CastCache, ModelSplit,
                     apply_rope, cross_entropy, decode_attention, dense_init,
                     embed_init, head_input, heads_flat, lookup,
                     maybe_constrain, mesh_zeros, model_axis_size,
                     nest_layers, remat_wrap, rms_norm, rope_cos_sin)

#: the families this module builds
FAMILIES = ("dense", "moe", "vlm")


def _swiglu(cfg: ArchConfig) -> bool:
    """SwiGLU (``ffn_mult`` 3) or the GELU MLP (any other), as the
    reference picks."""
    return cfg.ffn_mult == 3


def attention_mode(cfg: ArchConfig, size: int) -> str:
    """How a model axis of ``size`` ranks splits the attention, as the
    reference's layouts do: "heads" where the query and kv heads split
    into whole heads (each rank its heads); "shared_kv" where the query
    heads split and the kv heads do not (each rank its query heads and
    the kv heads they read, as the reference's repeat of the kv heads
    gives them); "split_keys" where the query heads do not split (every
    head whole on every rank, the keys' sequence split over the ranks:
    the reference's ``_kv_seq_spec``).  The leaves are cut by their flat
    columns in every mode (``launch/sharding.py::model_block``)."""
    if size == 1 or (cfg.n_heads % size == 0 and cfg.n_kv % size == 0):
        return "heads"
    return "shared_kv" if cfg.n_heads % size == 0 else "split_keys"


def _matrices(cfg: ArchConfig, split: ModelSplit = WHOLE) -> dict:
    """The per-layer matrices of the reference, by shape (the experts'
    are ``moe_lib.MoEFFN``'s), or ``split``'s block of them: wq, wk, wv
    and the FFN's first matrices by columns (wq, wk and wv by their flat
    H hd / KV hd columns, whole heads where the heads split), wo and
    w_down by rows."""
    d, hd = cfg.d_model, cfg.head_dim
    Hc = split.part(cfg.n_heads * hd, "query columns")
    KVc = split.part(cfg.n_kv * hd, "kv columns")
    out = {"wq": (d, Hc), "wk": (d, KVc), "wv": (d, KVc), "wo": (Hc, d)}
    if cfg.moe_experts > 0:
        return out
    ff = split.part(cfg.d_ff, "FFN columns")
    if _swiglu(cfg):
        out["w_gate"] = (d, ff)
    out.update(w_up=(d, ff), w_down=(ff, d))
    return out


def _vectors(cfg: ArchConfig) -> dict:
    """The per-layer norm scales of the reference, by shape (all start at
    one)."""
    out = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    if cfg.qk_norm:
        out.update(q_norm=(cfg.head_dim,), k_norm=(cfg.head_dim,))
    return out


def _biases(cfg: ArchConfig, split: ModelSplit = WHOLE) -> dict:
    """The per-layer biases of the reference, by shape (all start at
    zero): q, k and v with ``qkv_bias``, the GELU MLP's two; under
    ``split`` each cut as its matrix's columns, ``b_down`` whole (added
    after the row-parallel sum)."""
    hd = cfg.head_dim
    Hc = split.part(cfg.n_heads * hd, "query columns")
    KVc = split.part(cfg.n_kv * hd, "kv columns")
    out = {}
    if cfg.qkv_bias:
        out.update(bq=(Hc,), bk=(KVc,), bv=(KVc,))
    if not _swiglu(cfg) and cfg.moe_experts == 0:
        out.update(b_up=(split.part(cfg.d_ff, "FFN columns"),),
                   b_down=(cfg.d_model,))
    return out


#: the residual stream on a mesh: the batch over the data axes
_RESIDUAL = (DATA, None, None)
#: the FFN's hidden activations on a mesh: the batch over the data axes,
#: the hidden columns over "model" (where they divide)
_HIDDEN = (DATA, None, "model")


def attention_layout(q, k, v) -> tuple:
    """q, k and v with the reference's layout hints on DTensors
    (``full_attention`` / ``chunked_attention``,
    ``repro/models/common.py:218-227``): where the query heads split over
    "model", all three over the data axes and their heads over "model"
    (kv heads repeated per query head first when they do not split over
    it, as the reference's ``jnp.repeat``); where they do not, q whole over
    "model" and the keys' sequence split over it (``_kv_seq_spec``), so
    that ``flash_attention`` has each model rank attend to its block of
    the keys and combines the blocks' softmaxes
    (``kernels/flash/split.py``).  Plain tensors are returned as they
    are."""
    tp = model_axis_size(q)
    if tp == 1:
        return q, k, v
    H, KV = q.shape[2], k.shape[2]
    if H % tp:
        return (maybe_constrain(q, (DATA, None, None, None)),
                *(maybe_constrain(t, (DATA, "model", None, None))
                  for t in (k, v)))
    if KV % tp:
        # whole heads around the repeat, its gradient's sum included
        k, v = (maybe_constrain(t.repeat_interleave(H // KV, dim=2),
                                (DATA, None, None, None)) for t in (k, v))
    return tuple(maybe_constrain(t, (DATA, None, "model", None))
                 for t in (q, k, v))


def attention(q, k, v, window: int = 0):
    """Causal attention over the whole sequence (K2 through
    ``flash_attention``) in the reference's layout on a mesh
    (:func:`attention_layout`)."""
    return flash_attention(*attention_layout(q, k, v), causal=True,
                           window=window)


def check_config(cfg: ArchConfig) -> None:
    """Raise for a config this module does not build: it builds the
    dense, MoE and VLM families with every option of the reference's."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} is not a transformer's; the transformer "
            f"builds {', '.join(FAMILIES)}")


def project_qkv(layer, x, cos=None, sin=None) -> tuple:
    """The reference's ``_project_qkv`` of ``layer`` (a module with ``cfg``,
    ``w(name, dtype)`` and the q/k norms): x (B, S, d) -> q (B, S, H, hd),
    k and v (B, S, KV, hd), with the QKV biases and the per-head qk-norm
    of the config, then RoPE when ``cos`` / ``sin`` are given.  H and KV
    are the heads the layer holds (a :class:`ModelSplit`'s block)."""
    cfg = layer.cfg
    B, S, _ = x.shape
    hd, dt = cfg.head_dim, x.dtype
    q, k, v = (x @ layer.w(n, dt) for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + layer.w("bq", dt)
        k = k + layer.w("bk", dt)
        v = v + layer.w("bv", dt)
    q, k, v = (heads_flat(t, n) for t, n in
               ((q, cfg.n_heads), (k, cfg.n_kv), (v, cfg.n_kv)))
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    return (*_norm_rope(layer, q, k, cos, sin), v)


def _norm_rope(layer, q, k, cos, sin) -> tuple:
    """q and k (B, S, n, hd) after the config's per-head qk-norm and, when
    ``cos`` / ``sin`` are given, RoPE."""
    cfg = layer.cfg
    if cfg.qk_norm:
        q = rms_norm(q, layer.q_norm, cfg.norm_eps)
        k = rms_norm(k, layer.k_norm, cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k


class TransformerLayer(nn.Module):
    """One block (the reference's ``block_fwd``), whole or ``split``'s
    block of it: then the attention runs in :func:`attention_mode`'s
    layout on the rank's flat columns and the FFN on its columns (or
    experts), each between ``split.enter`` and ``split.exit``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 split: ModelSplit = WHOLE):
        super().__init__()
        self.cfg = cfg
        self.split = split
        self.mode = attention_mode(cfg, split.size)
        if self.mode == "shared_kv":
            self._kv_heads = _kv_heads_read(cfg, split)
        for name, shape in {**_vectors(cfg), **_biases(cfg, split),
                            **_matrices(cfg, split)}.items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=cfg.param_dtype, device=device)))
        if cfg.moe_experts > 0:
            self.moe = moe_lib.MoEFFN(cfg, device, split)
        self._cast = CastCache()

    def w(self, name: str, dtype) -> torch.Tensor:
        """Parameter ``name`` in ``dtype``."""
        return self._cast.get(name, getattr(self, name), dtype)

    def _ffn(self, h):
        """The FFN (``common.gelu_mlp``'s ops for the GELU MLP, its
        ``b_down`` added after the model group's sum)."""
        dt, sp = h.dtype, self.split
        h = sp.enter(h)
        if self.cfg.moe_experts > 0:
            return sp.exit(self.moe(h))
        if _swiglu(self.cfg):
            h = F.silu(h @ self.w("w_gate", dt)) * (h @ self.w("w_up", dt))
            h = maybe_constrain(h, _HIDDEN)
            return sp.exit(h @ self.w("w_down", dt))
        h = F.gelu(h @ self.w("w_up", dt) + self.w("b_up", dt),
                   approximate="tanh")
        h = maybe_constrain(h, _HIDDEN)
        return sp.exit(h @ self.w("w_down", dt)) + self.w("b_down", dt)

    def _columns(self, h, name: str):
        """h times this rank's columns of ``w<name>`` (its bias added)."""
        dt = h.dtype
        t = h @ self.w("w" + name, dt)
        return t + self.w("b" + name, dt) if self.cfg.qkv_bias else t

    def _split_attention(self, h, cos, sin):
        """The attention of a layer whose heads do not split over the
        model group (:func:`attention_mode`), from the block's entered
        input h (B, S, d): returns this rank's columns of the attention's
        flat output (B, S, H hd / size), the rows of ``wo`` it holds.

        "split_keys": q, k and v from the rank's columns, gathered whole
        over the group; the qk-norm and RoPE on whole heads; the rank's
        block of the keys' sequence (``kernels/flash/split.py::
        key_blocks``) and split-key attention over the group.
        "shared_kv": the rank's whole query heads; k and v gathered whole
        over the group (their gradient summed over the ranks that read a
        kv head), then the kv heads its query heads read."""
        cfg, sp = self.cfg, self.split
        B, S, _ = h.shape
        hd = cfg.head_dim
        if self.mode == "split_keys":
            q, k, v = (sp.gather(self._columns(h, n), -1).reshape(
                B, S, -1, hd) for n in "qkv")
            q, k = _norm_rope(self, q, k, cos, sin)
            blocks = key_blocks(S, sp.size)
            k, v = (sp.split(t, 1, blocks) for t in (k, v))
            o = split_key_local(q, k, v, k_offset=blocks[sp.rank][0],
                                reduce=sp.reduce, causal=True,
                                window=cfg.sliding_window)
            n = cfg.n_heads * hd // sp.size
            return sp.split(o.reshape(B, S, -1), -1,
                            [(r * n, (r + 1) * n) for r in range(sp.size)])
        q = self._columns(h, "q").reshape(B, S, -1, hd)
        k, v = (sp.enter(sp.gather(self._columns(h, n), -1)).reshape(
            B, S, cfg.n_kv, hd)[:, :, self._kv_heads] for n in "kv")
        q, k = _norm_rope(self, q, k, cos, sin)
        o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
        return o.reshape(B, S, -1)

    def forward(self, x, cos=None, sin=None, *, cache=None, pos=None):
        """x (B, S, d); cos/sin from ``rope_cos_sin`` at the positions of
        ``x`` (None without RoPE).

        Without ``cache`` (prefill, the sequence starting at position 0):
        returns (x, (k, v)), the keys and values to store (None where the
        heads do not split over the layer's model group).  With ``cache``
        = (k_cache, v_cache) of shape (B, T, KV, hd) and S == 1 (decode):
        writes this token's k and v into the cache at ``min(pos, T - 1)``
        in place (the reference's clamp) and returns (x, cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        dt = x.dtype
        h = self.split.enter(rms_norm(x, self.ln1, cfg.norm_eps))
        if self.mode != "heads":
            x = x + self.split.exit(self._split_attention(h, cos, sin)
                                    @ self.w("wo", dt))
            x = x + self._ffn(rms_norm(x, self.ln2, cfg.norm_eps))
            return x, None
        q, k, v = project_qkv(self, h, cos, sin)
        if cache is None:
            attn = attention(q, k, v, cfg.sliding_window)
            new = (k, v)
        else:
            k_cache, v_cache = cache
            # the reference's dynamic_update_slice clamps the start to
            # T - 1; an empty slice at pos == T would drop the write
            at = min(pos, k_cache.shape[1] - 1)
            k_cache[:, at:at + 1] = k
            v_cache[:, at:at + 1] = v
            attn = decode_attention(q, k_cache, v_cache, pos)
            new = cache
        attn = heads_flat(attn.reshape(B, S, -1), cfg.n_heads)
        x = x + self.split.exit(attn @ self.w("wo", dt))
        # on a mesh the row-parallel products leave partial sums: the
        # residual stream is summed over "model" (the model group's sum)
        x = maybe_constrain(x, _RESIDUAL)
        x = x + self._ffn(rms_norm(x, self.ln2, cfg.norm_eps))
        return maybe_constrain(x, _RESIDUAL), new


def _kv_heads_read(cfg: ArchConfig, split: ModelSplit):
    """The kv heads that rank ``split.rank``'s query heads read (query
    head h reads kv head h // (H / KV)): a slice where they form whole
    GQA groups of its heads, else one index per query head."""
    Hl = cfg.n_heads // split.size
    g = cfg.n_heads // cfg.n_kv
    idx = [(split.rank * Hl + j) // g for j in range(Hl)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if Hl % n == 0 and all(i - lo == j // (Hl // n)
                           for j, i in enumerate(idx)):
        return slice(lo, lo + n)
    return idx


class Transformer(nn.Module):
    """The model: embedding, the layers, the final norm; the head is the
    embedding transposed (``tie_embeddings``) or ``lm_head``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        self.embed = nn.Parameter(torch.empty((cfg.vocab, d), dtype=pd,
                                              device=device))
        self.layers = nn.ModuleList(TransformerLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty(d, dtype=pd,
                                                   device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, cfg.vocab), dtype=pd,
                                                    device=device))
        self._cast = CastCache()

    def embed_tokens(self, tokens, extra_embeds=None) -> torch.Tensor:
        """The reference's ``_embed``: rows of the table in the compute
        type, after ``extra_embeds`` (B, P, d) in it when given."""
        x = self.embed[tokens.long()].to(self.cfg.compute_dtype)
        if extra_embeds is not None:
            extra = torch.as_tensor(extra_embeds, device=x.device)
            x = torch.cat([extra.to(x.dtype), x], dim=1)
        # the residual stream over the data axes after the vocab-sharded
        # gather (the reference's hint)
        return maybe_constrain(x, _RESIDUAL)

    def logits(self, x) -> torch.Tensor:
        """The reference's ``_unembed``: the final norm, then the tied head
        (``embed.T``) or ``lm_head``."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        # on a mesh: the vocab over "model" (or, where it does not split,
        # the tokens), and the logits' gradient too (the head's weight
        # gradient then splits as its product does)
        x, spec = head_input(x, self.cfg.vocab)
        if self.cfg.tie_embeddings:
            logits = x @ self._cast.get("embed", self.embed, x.dtype).T
        else:
            logits = x @ self._cast.get("lm_head", self.lm_head, x.dtype)
        return maybe_constrain(logits, spec)

    def rope(self, positions):
        """(cos, sin) at ``positions``, or (None, None) without RoPE."""
        if not self.cfg.use_rope:
            return None, None
        return rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Transformer:
    """The reference's initializer on ``device``, drawn from ``generator``
    (which must live on that device).  ``jax.random`` streams cannot be
    reproduced in torch; to start from the reference's own weights use
    :func:`params_from_jax`."""
    model = Transformer(cfg, device)
    pd = cfg.param_dtype
    with torch.no_grad():
        model.embed.copy_(embed_init(generator, (cfg.vocab, cfg.d_model), pd,
                                     device))
        for layer in model.layers:
            for name in _vectors(cfg):
                getattr(layer, name).fill_(1.0)
            for name in _biases(cfg):
                getattr(layer, name).zero_()
            for name, shape in _matrices(cfg).items():
                getattr(layer, name).copy_(
                    dense_init(generator, shape, pd, device))
            if cfg.moe_experts > 0:
                moe_lib.init_moe_params(layer.moe, generator)
        model.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            model.lm_head.copy_(dense_init(generator, (cfg.d_model,
                                                       cfg.vocab), pd, device))
    return model


def params_from_jax(tree, cfg: ArchConfig, device) -> Transformer:
    """Carry the reference's ``init_params`` tree (numpy arrays; per-layer
    parameters stacked on a leading ``L`` axis) into a model on
    ``device``, in ``cfg.param_dtype``."""
    model = Transformer(cfg, device)

    def put(p, a):
        p.copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))

    with torch.no_grad():
        for name, p in model.named_parameters():
            put(p, lookup(tree, name))
    return model


def params_to_jax(model: Transformer) -> dict:
    """The inverse of :func:`params_from_jax`: the reference's tree, as
    float32 numpy arrays (the experts under ``layers["moe"]``)."""
    return nest_layers({n: p.detach().float().cpu().numpy()
                        for n, p in model.named_parameters()}, np.stack)


def make_cache(cfg: ArchConfig, batch: int, cache_len: int, device,
               dtype=None) -> dict:
    """Zeroed KV cache: k and v of shape (L, B, cache_len, KV, hd) in the
    compute type."""
    shape = (cfg.num_layers, batch, cache_len, cfg.n_kv, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mesh_cache(cfg: ArchConfig, k, cache_len: int) -> dict:
    """:func:`make_cache` as DTensors (the dry run's sharded prefill),
    each layer's slot laid out as the keys ``k`` (B, S, KV, hd) it
    holds."""
    spec = make_cache(cfg, k.shape[0], cache_len, "meta", k.dtype)
    return {n: mesh_zeros(t, k) for n, t in spec.items()}


def _layer_train(layer, x, cos, sin):
    return layer(x, cos, sin)[0]


def forward_hidden(model: Transformer, tokens,
                   extra_embeds=None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, P + S, d), after the P
    ``extra_embeds`` when given, every layer under
    ``remat_wrap(cfg.remat)``; differentiable (the training forward)."""
    x = model.embed_tokens(tokens, extra_embeds)
    cos, sin = model.rope(torch.arange(x.shape[1], device=x.device))
    for layer in model.layers:
        x = remat_wrap(functools.partial(_layer_train, layer),
                       model.cfg.remat)(x, cos, sin)
    return x


def loss_fn(model: Transformer, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({tokens, labels}, (B, S)
    each, tensors or arrays; and ``patch_embeds`` (B, P, d), whose
    positions the loss leaves out) — the reference's ``loss_fn``."""
    dev = model.embed.device
    patches = batch.get("patch_embeds")
    x = forward_hidden(model, torch.as_tensor(batch["tokens"], device=dev),
                       patches)
    if patches is not None:
        x = x[:, patches.shape[1]:]
    return cross_entropy(model.logits(x),
                         torch.as_tensor(batch["labels"], device=dev))


@torch.no_grad()
def prefill(model: Transformer, tokens, cache_len: int, extra_embeds=None):
    """Run the whole prompt (after the P ``extra_embeds``, when given) from
    position 0, build the KV cache; returns (last-position logits (B, 1,
    V), cache).  The prompt's P + S positions must fit ``cache_len``."""
    x = model.embed_tokens(tokens, extra_embeds)
    B, S = x.shape[:2]
    if S > cache_len:
        raise ValueError(f"a {S}-position prompt does not fit a cache of "
                         f"{cache_len}")
    cos, sin = model.rope(torch.arange(S, device=x.device))
    on_mesh = isinstance(x, DTensor)
    cache = None if on_mesh else make_cache(model.cfg, B, cache_len,
                                            x.device)
    for i, layer in enumerate(model.layers):
        x, (k, v) = layer(x, cos, sin)
        if cache is None:
            cache = _mesh_cache(model.cfg, k, cache_len)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return model.logits(x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, token, pos: int):
    """One token (B, 1) at position ``pos`` (the cache already holds
    ``pos`` valid entries) through every layer; returns (logits, cache).
    The cache is updated in place — the returned dict is ``cache`` — where
    the reference returns a new one."""
    x = model.embed_tokens(token)
    cos, sin = model.rope(torch.tensor([pos], device=x.device))
    for i, layer in enumerate(model.layers):
        x, _ = layer(x, cos, sin, cache=(cache["k"][i], cache["v"][i]),
                     pos=pos)
    return model.logits(x), cache


__all__ = ["Transformer", "TransformerLayer", "attention", "check_config",
           "decode_step",
           "forward_hidden", "init_params", "loss_fn", "make_cache",
           "params_from_jax", "params_to_jax", "prefill", "project_qkv"]
