"""Step-function factories shared by the trainer and the server — the port
of ``repro/launch/steps.py``.

``train_step`` does micro-batched gradient accumulation
(``pipeline/executor.py::microbatch_grads``) — the single-device
counterpart of the paper's micro-batching (Theorem 1 picks Q) — followed by
the optimizer update, in place.  The update sees the tree
:func:`optimizer_tree` gives: the model's named parameters for an
elementwise optimizer, and for Adafactor the reference's layout, each
per-layer parameter stacked over the layers, as the reference's
``make_train_step`` hands its optimizer the stacked tree (Adafactor
factors and clips each whole leaf, so the layout changes its update).
``prefill_step`` / ``decode_step`` are the serving entries.  Every factory
runs on ``"cuda"`` unless the caller passes ``device="cpu"``; without a GPU
it raises.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import ArchConfig, lookup, nest_layers
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


def _on(x, device: torch.device):
    """``x`` as a tensor on ``device``'s type: a tensor already there, or
    a DTensor (the dry run's, laid out by its mesh), as it is; anything
    else through ``torch.as_tensor``."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) or (isinstance(x, torch.Tensor)
                                  and x.device.type == device.type):
        return x
    return torch.as_tensor(x, device=device)


def optimizer_tree(named: dict, optimizer: Optimizer) -> dict:
    """The tree ``optimizer`` updates, from a model's named tensors
    (parameters or their gradients): the named tensors themselves for an
    elementwise optimizer (the layout changes no bit of its update), else
    the reference's layout, top-level tensors as they are and each
    per-layer name stacked over the layers (a copy)."""
    if optimizer.elementwise:
        return named
    with torch.no_grad():
        return nest_layers(named, torch.stack)


def init_optimizer(optimizer: Optimizer, model) -> dict:
    """``optimizer``'s state for ``model``, in :func:`optimizer_tree`'s
    layout (Adafactor's moments stacked over the layers, as the
    reference's)."""
    return optimizer.init(optimizer_tree(dict(model.named_parameters()),
                                         optimizer))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    num_microbatches: int, device="cuda") -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state, loss)``:
    the mean loss and gradients over ``num_microbatches`` micro-batches of
    ``batch`` ({tokens, labels}, (B, S) each; and ``patch_embeds`` for a
    VLM), then one optimizer update of the model's parameters in place;
    ``opt_state`` comes from :func:`init_optimizer`.  ``loss`` is a 0-d
    float32 tensor on the device.

    For Adafactor the update runs on stacked copies of the per-layer
    parameters and gradients and writes the result back: while it runs it
    holds one more copy of the per-layer parameters, and while the
    gradients are stacked, two copies of them."""
    api = get_model(cfg, device)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        batch = {k: _on(v, api.device) for k, v in batch.items()}
        loss, grads = microbatch_grads(lambda _p, mb: api.loss(model, mb),
                                       list(params.values()), batch,
                                       num_microbatches)
        grads = dict(zip(params, grads))
        tree = optimizer_tree(params, optimizer)
        grads = optimizer_tree(grads, optimizer)
        _, opt_state = optimizer.update(tree, grads, opt_state)
        if tree is not params:
            with torch.no_grad():
                for name, p in params.items():
                    new = lookup(tree, name)
                    if new is not p:
                        p.copy_(new)
        return model, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int,
                      device="cuda") -> Callable:
    api = get_model(cfg, device)

    def prefill_step(model, batch):
        return api.prefill(model, {k: _on(v, api.device)
                                   for k, v in batch.items()}, cache_len)

    return prefill_step


def make_decode_step(cfg: ArchConfig, device="cuda") -> Callable:
    api = get_model(cfg, device)

    def decode_step(model, cache, token, pos):
        return api.decode(model, cache, _on(token, api.device), pos)

    return decode_step
