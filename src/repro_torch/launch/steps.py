"""Step-function factories shared by the trainer and the server — the port
of ``repro/launch/steps.py``.

``train_step`` does micro-batched gradient accumulation
(``pipeline/executor.py::microbatch_grads``) — the single-device
counterpart of the paper's micro-batching (Theorem 1 picks Q) — followed by
the optimizer update, in place.  ``prefill_step`` / ``decode_step`` are the
serving entries.  Every factory runs on ``"cuda"`` unless the caller passes
``device="cpu"``; without a GPU it raises.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.optim import Optimizer
from repro_torch.pipeline.executor import microbatch_grads

# Optimizer policy: AdamW by default; factored second moments once fp32
# moments stop fitting (>= ~100B params on a 256-chip pod).
BIG_MODEL_OPTIMIZER_THRESHOLD = 100e9


def default_optimizer_name(cfg: ArchConfig) -> str:
    from repro_torch.configs.base import count_params
    return ("adafactor" if count_params(cfg) >= BIG_MODEL_OPTIMIZER_THRESHOLD
            else "adamw")


def default_microbatches(cfg: ArchConfig, global_batch: int) -> int:
    """Gradient-accumulation depth Q for the train shape.  The planner
    (Theorem 1) refines this; the default keeps per-microbatch activations
    bounded for the largest configs.  Configs can pin Q."""
    q = cfg.train_microbatches
    if q <= 0:
        q = 8
        if cfg.d_model >= 8192 or cfg.num_layers >= 64:
            q = 16
    while global_batch % q:
        q //= 2
    return max(q, 1)


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    num_microbatches: int, device="cuda") -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state, loss)``:
    the mean loss and gradients over ``num_microbatches`` micro-batches of
    ``batch`` ({tokens, labels}, (B, S) each), then one optimizer update of
    the model's parameters in place; ``opt_state`` comes from
    ``optimizer.init(dict(model.named_parameters()))``.  ``loss`` is a 0-d float32
    tensor on the device."""
    api = get_model(cfg, device)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        batch = {k: torch.as_tensor(v, device=api.device)
                 for k, v in batch.items()}
        loss, grads = microbatch_grads(lambda _p, mb: api.loss(model, mb),
                                       list(params.values()), batch,
                                       num_microbatches)
        _, opt_state = optimizer.update(params, dict(zip(params, grads)),
                                        opt_state)
        return model, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int,
                      device="cuda") -> Callable:
    api = get_model(cfg, device)

    def prefill_step(model, batch):
        tokens = torch.as_tensor(batch["tokens"], device=api.device)
        return api.prefill(model, {"tokens": tokens}, cache_len)

    return prefill_step


def make_decode_step(cfg: ArchConfig, device="cuda") -> Callable:
    api = get_model(cfg, device)

    def decode_step(model, cache, token, pos):
        return api.decode(model, cache,
                          torch.as_tensor(token, device=api.device), pos)

    return decode_step
