"""Single-process pipelined-SL executors — the port of
``repro/pipeline/executor.py``.

1. ``microbatch_grads`` — gradient accumulation over micro-batches; the
   mean of micro-batch means equals the full-batch gradient (the paper's
   synchronous-SGD guarantee: pipelining changes latency, not the update).

2. ``SplitLearningExecutor`` — the paper's multi-hop SL semantics made
   runnable on one device: submodels (from a core.Plan) execute as separate
   stages with explicit activation hand-offs, per-link hooks, and a latency
   ledger driven by the core latency model.

PyTorch runs eagerly, so there is no compiled step to cache: the
reference's ``executor.jit_*`` counters have no counterpart here.
Gradients accumulate and parameters update in place, which saves a copy of
the model per micro-batch and per round.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch

from .. import obs
from .._device import resolve_device
from ..core.bcd import Plan
from ..models import vgg as vgg_lib
from ..models.common import DATA, cross_entropy, maybe_constrain
from .stage import split_vgg_params, vgg_stages_from_cuts


def _batch_split(x) -> int:
    """How many blocks a DTensor's dim 0 is cut into (0 for a plain
    tensor: nothing to cut)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return 0
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            n *= x.device_mesh.size(i)
    return n if n > 1 else 0


def split_batch(batch: dict, num_microbatches: int) -> dict:
    """(B, ...) -> (Q, B/Q, ...) for every entry of ``batch``, each
    micro-batch's batch dim kept over the data axes of a DTensor's mesh
    (the reference's hint: the reshape alone would lose it)."""
    def resh(x):
        B = x.shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{num_microbatches} micro-batches")
        n = _batch_split(x)
        if n and num_microbatches % n:
            # DTensor keeps a split dim's blocks on the reshape's outer dim
            # (Q), which n blocks must divide: gather the batch first
            x = maybe_constrain(x, (None,) * x.dim())
        y = x.reshape((num_microbatches, B // num_microbatches)
                      + tuple(x.shape[1:]))
        return maybe_constrain(y, (None, DATA) + (None,) * (y.dim() - 2))
    return {k: resh(v) for k, v in batch.items()}


def microbatch_grads(loss_fn: Callable, params, batch: dict,
                     num_microbatches: int):
    """Mean loss + grads accumulated over micro-batches (== full batch).

    ``params`` is a sequence of leaf tensors; ``loss_fn(params, mbatch)``
    returns a scalar computed from them.  Returns ``(loss, grads)`` with
    ``grads`` aligned to ``params``.
    """
    params = list(params)
    mb = split_batch(batch, num_microbatches)
    loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
    grad_sum = [torch.zeros_like(p) for p in params]
    for q in range(num_microbatches):
        loss = loss_fn(params, {k: v[q] for k, v in mb.items()})
        grads = torch.autograd.grad(loss, params)
        loss_sum = loss_sum + loss.detach()
        for acc, g in zip(grad_sum, grads):
            acc.add_(g)
    scale = 1.0 / num_microbatches
    return loss_sum * scale, [g * scale for g in grad_sum]


@dataclasses.dataclass
class LinkHooks:
    """Per-link transforms for activations / gradients (compression/...)."""
    fwd: Callable = lambda x: x
    bwd: Callable = lambda g: g


def _shapes(nested) -> list:
    return [[tuple(t.shape) for t in group] for group in nested]


class SplitLearningExecutor:
    """Runs one training round of pipelined SL per the paper's Plan.

    The compute graph is *identical* to centralized training (stages chain
    to the full model; autograd crosses each cut — the activation-gradient
    hand-off of Eq. (9)), while the latency ledger accounts
    T_f + ceil((B-b)/b)*T_i per round from the analytical model.

    ``params`` (e.g. from :func:`repro_torch.models.vgg.params_from_jax`)
    replaces the port's own seeded initializer; the executor trains a copy
    of it on ``device`` (``"cuda"`` unless ``"cpu"`` is asked for).
    """

    def __init__(self, plan: Plan, profile, net, *, hooks: LinkHooks = None,
                 seed: int = 0, params=None, device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        self.profile = profile
        self.net = net
        self.hooks = hooks or LinkHooks()
        if params is None:
            params = vgg_lib.init_params(torch.Generator().manual_seed(seed))
        else:
            params = copy.deepcopy(params)
        self.full_params = params.to(self.device)
        self.stages = vgg_stages_from_cuts(plan.solution.cuts,
                                           self.full_params)
        self.round_latency = plan.L_t
        self.simulated_time = 0.0
        self._velocity = None

    def stage_params(self) -> list:
        return split_vgg_params(self.full_params, self.plan.solution.cuts)

    def _to_device(self, batch: dict) -> dict:
        return {"images": torch.as_tensor(batch["images"],
                                          dtype=torch.float32,
                                          device=self.device),
                "labels": torch.as_tensor(batch["labels"], dtype=torch.long,
                                          device=self.device)}

    def _forward_chain(self, x):
        """Client -> servers with link hooks at every cut (Eqs. 5/6).  On
        the GPU a stage span measures the host's enqueue time."""
        acts = [x]
        for k, stage in enumerate(self.stages):
            with obs.span("executor.stage_fwd", stage=k):
                x = stage(x)
                x = self.hooks.fwd(x)
            acts.append(x)
        return x, acts

    def loss(self, batch) -> torch.Tensor:
        logits, _ = self._forward_chain(batch["images"])
        return cross_entropy(logits[:, None, :], batch["labels"][:, None])

    def train_round(self, batch, lr: float = 0.05, momentum: float = 0.0):
        """One mini-batch (NHWC images): micro-batched grads + SGD
        (optionally with heavy-ball ``momentum``); advances the simulated
        clock.  Returns the mean loss as a Python float."""
        batch = self._to_device(batch)
        groups = [list(stage.parameters()) for stage in self.stages]
        params = [p for group in groups for p in group]
        q = self.plan.num_microbatches
        B = batch["images"].shape[0]
        q = max(1, min(q, B))
        while B % q:
            q -= 1
        obs.inc("executor.train_rounds")
        with obs.span("executor.step", q=q, B=B):
            loss, grads = microbatch_grads(
                lambda _params, mb: self.loss(mb), params, batch, q)
            if obs.enabled() and self.device.type == "cuda":
                # kernels run asynchronously: end the span when they finish
                torch.cuda.synchronize(self.device)
        nested, pos = [], 0
        for group in groups:
            nested.append(grads[pos:pos + len(group)])
            pos += len(group)
        if momentum:
            vel = self._velocity
            # a replan can change the cuts (a different stage grouping):
            # restart the buffer whenever the gradients' grouping changed
            if vel is None or _shapes(vel) != _shapes(nested):
                vel = [[torch.zeros_like(g) for g in group]
                       for group in nested]
            vel = [[momentum * v + g for v, g in zip(vg, gg)]
                   for vg, gg in zip(vel, nested)]
            self._velocity = vel
            nested = vel
        with torch.no_grad():
            for group, grad_group in zip(groups, nested):
                for p, g in zip(group, grad_group):
                    p.sub_(lr * g)
        self.simulated_time += self.round_latency
        return float(loss)

    def evaluate(self, batch) -> float:
        batch = self._to_device(batch)
        with torch.no_grad():
            logits = vgg_lib.forward(self.full_params, batch["images"])
        return float((logits.argmax(-1) == batch["labels"]).float().mean())
