"""Uniform model API — the port of ``repro/models/registry.py``, for every
family of the reference: ``ssm`` (RWKV6, ``rwkv6-1.6b``); ``dense`` (the
decoder-only transformer, ``qwen3-0.6b``, ``llama3-8b``, ``qwen1.5-4b`` and
``command-r-35b``, with QKV biases, the GELU MLP, an untied head and
sliding windows); ``moe`` (the transformer with a mixture of experts,
``granite-moe-3b-a800m`` and ``qwen3-moe-235b-a22b``); ``vlm`` (the
transformer after patch embeddings, ``internvl2-1b``, whose prefill reads
``batch["patch_embeds"]``); ``hybrid`` (Jamba's Mamba, attention and MoE
layers, ``jamba-1.5-large-398b``); ``audio`` (the Whisper encoder-decoder,
``whisper-small``, whose loss and prefill read ``batch["frames"]``).

    api = get_model(cfg, device="cuda")
    model = api.init(generator)                         # on api.device
    loss = api.loss(model, batch)                       # batch: dict of tensors
    logits, cache = api.prefill(model, batch, cache_len)
    logits, cache = api.decode(model, cache, token, pos)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .._device import resolve_device
from . import jamba as jamba_lib
from . import rwkv6 as rwkv_lib
from . import transformer as tf_lib
from . import vlm as vlm_lib
from . import whisper as whisper_lib
from .common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    device: torch.device
    init: Callable            # (generator) -> model on device
    loss: Callable            # (model, batch) -> scalar (with grad)
    prefill: Callable         # (model, batch, cache_len) -> (logits, cache)
    decode: Callable          # (model, cache, token, pos) -> (logits, cache)

    def param_count(self, params) -> int:
        return sum(p.numel() for p in params.parameters())


def get_model(cfg: ArchConfig, device="cuda") -> ModelAPI:
    """The model API of ``cfg``'s family on ``device`` (``"cuda"`` unless
    the caller asks for the CPU; raises without a GPU)."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return ModelAPI(
            cfg=cfg, device=dev,
            init=lambda g: rwkv_lib.init_params(cfg, g, dev),
            loss=rwkv_lib.loss_fn,
            prefill=lambda m, b, n: rwkv_lib.prefill(m, b["tokens"], n),
            decode=lambda m, c, t, pos: rwkv_lib.decode_step(m, c, t, pos),
        )
    if cfg.family in ("dense", "moe"):
        return ModelAPI(
            cfg=cfg, device=dev,
            init=lambda g: tf_lib.init_params(cfg, g, dev),
            loss=tf_lib.loss_fn,
            prefill=lambda m, b, n: tf_lib.prefill(m, b["tokens"], n),
            decode=lambda m, c, t, pos: tf_lib.decode_step(m, c, t, pos),
        )
    if cfg.family == "vlm":
        return ModelAPI(
            cfg=cfg, device=dev,
            init=lambda g: vlm_lib.init_params(cfg, g, dev),
            loss=vlm_lib.loss_fn,
            prefill=lambda m, b, n: vlm_lib.prefill(
                m, b["tokens"], b["patch_embeds"], n),
            decode=lambda m, c, t, pos: vlm_lib.decode_step(m, c, t, pos),
        )
    if cfg.family == "hybrid":
        return ModelAPI(
            cfg=cfg, device=dev,
            init=lambda g: jamba_lib.init_params(cfg, g, dev),
            loss=jamba_lib.loss_fn,
            prefill=lambda m, b, n: jamba_lib.prefill(m, b["tokens"], n),
            decode=lambda m, c, t, pos: jamba_lib.decode_step(m, c, t, pos),
        )
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg, device=dev,
            init=lambda g: whisper_lib.init_params(cfg, g, dev),
            loss=whisper_lib.loss_fn,
            prefill=lambda m, b, n: whisper_lib.prefill(
                m, b["frames"], b["tokens"], n),
            decode=lambda m, c, t, pos: whisper_lib.decode_step(
                m, c, t, pos),
        )
    raise ValueError(f"unknown family {cfg.family!r}")
