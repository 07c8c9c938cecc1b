"""The reference's optimizer suite on tensors — the port of
``repro/optim/optimizers.py``.

Each optimizer is a pair of functions over a tree of parameter tensors (a
list, tuple or dict, nested or not) with the reference's formulas, not a
``torch.optim`` class: ``torch.optim.AdamW`` applies the weight decay before
the Adam step, where the reference subtracts ``lr * (m^ / (sqrt(v^) + eps)
+ wd * p)`` at once, and torch has no Adafactor.

    opt = get_optimizer("adamw", lr=1e-3)
    state = opt.init(params)                 # a tree of tensors
    params, state = opt.update(params, grads, state)

``update`` works leaf by leaf and writes the new values into the parameter
and moment tensors in place under ``torch.no_grad()`` (the reference's
arrays are immutable and it returns new ones): at full width a step then
holds one leaf's temporaries at a time, not a second copy of the model and
its moments.  Each in-place update rounds as the reference's expression
does (``b1 * m + (1 - b1) * g`` is ``m.mul_(b1).add_((1 - b1) * g)``).  It
returns the same trees, so the caller's modules see the step.  The state is
a dict of tensors (the step count a 0-d int32 tensor), which
``checkpoint/store.py`` saves as it is.  Moments live in the parameters'
type (Adafactor's in float32).

SGD, momentum and AdamW are elementwise: how the parameters are grouped
into leaves changes no bit of their update.  Adafactor is not: it factors
every leaf of two or more dimensions and clips by the rms of the whole
leaf, so the caller hands it the reference's leaves (``elementwise`` is
False; ``launch/steps.py::optimizer_tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.treemath import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable            # params -> opt_state
    update: Callable          # (params, grads, opt_state) -> (params, state)
    state_bytes_per_param: float
    elementwise: bool = True  # the update of each entry reads only it


def _tree_zeros(params):
    return tree_map(torch.zeros_like, params)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(params, grads, state):
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.sub_(lr * g.to(p.dtype))
        return params, state

    return Optimizer("sgd", init, update, 0.0)


def momentum(lr: float = 1e-2, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": _tree_zeros(params)}

    @torch.no_grad()
    def update(params, grads, state):
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            m.mul_(beta).add_(g.to(m.dtype))
            p.sub_(lr * m)
        return params, state

    return Optimizer("momentum", init, update, 4.0)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": _tree_zeros(params), "v": _tree_zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(params, grads, state):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), tf)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = g.to(m.dtype)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / bc1
            vh = v / bc2
            p.copy_(p - lr * (mh / (torch.sqrt(vh) + eps)
                              + weight_decay * p))
        return params, {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer("adamw", init, update, 8.0)


def _like(x, g):
    """``x``, broadcastable to ``g``, laid out as ``g`` over the dims where
    it is whole (a free slice of a replicated DTensor), so their product
    keeps ``g``'s blocks; a plain tensor as it is.  On the dry run's
    DTensors the factored moments' outer product would otherwise be made
    whole, at the leaf's global size, on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if not (isinstance(x, DTensor) and isinstance(g, DTensor)):
        return x
    place = tuple(p if p.is_shard() and x.shape[p.dim] == g.shape[p.dim]
                  else Replicate() for p in g.placements)
    return x if tuple(x.placements) == place else \
        x.redistribute(x.device_mesh, place)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern) — O(n+m) state for
    an (n, m) matrix instead of AdamW's O(nm).  momentum-free variant."""

    def init(params):
        def leaf_state(p):
            # new_zeros: on the parameter's device (and, for the dry run's
            # DTensors, on its mesh)
            f32 = dict(dtype=torch.float32)
            if p.dim() >= 2:
                return {"vr": p.new_zeros(p.shape[:-1], **f32),
                        "vc": p.new_zeros(p.shape[:-2] + (p.shape[-1],),
                                          **f32)}
            return {"v": p.new_zeros(p.shape, **f32)}
        dev = tree_leaves(params)[0].device
        return {"f": tree_map(leaf_state, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(params, grads, state):
        t = state["t"] + 1
        beta = 1.0 - (t.to(torch.float32) + 1.0) ** (-decay)
        leaf_states = []    # the per-parameter dicts, in the leaves' order
        tree_map(lambda p, s: leaf_states.append(s), params, state["f"])
        for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                           leaf_states):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if p.dim() >= 2:
                vr, vc = s["vr"], s["vc"]
                vr.copy_(beta * vr + (1 - beta) * g2.mean(-1))
                vc.copy_(beta * vc + (1 - beta) * g2.mean(-2))
                denom = (_like(vr[..., None], g) * _like(vc[..., None, :], g)
                         / torch.clamp_min(
                             vr.mean(-1, keepdim=True)[..., None], eps))
                u = g * torch.rsqrt(denom + eps)
            else:
                v = s["v"]
                v.copy_(beta * v + (1 - beta) * g2)
                u = g * torch.rsqrt(v + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            p.copy_(p - lr * u)
        return params, {"f": state["f"], "t": t}

    return Optimizer("adafactor", init, update, 0.1, elementwise=False)


_FACTORIES = {"sgd": sgd, "momentum": momentum, "adamw": adamw,
              "adafactor": adafactor}


def get_optimizer(name: str, **kw) -> Optimizer:
    return _FACTORIES[name](**kw)


def optimizer_state_bytes_per_param(name: str) -> float:
    """sigma~ contribution per parameter (Eq. 11's optimizer-state term)."""
    return {"sgd": 0.0, "momentum": 4.0, "adamw": 8.0,
            "adafactor": 0.1}[name]
