"""Optimizers on tensors (the reference's formulas, parameters updated in
place) + the optimizer-state byte model that feeds the paper's memory term
sigma~_i (Eq. 11).

SGD / Momentum / AdamW / Adafactor.  Adafactor (factored second moment) is
the default for >= 100B-parameter configs (``launch/steps.py``)."""

from .optimizers import (Optimizer, adafactor, adamw, get_optimizer,
                         momentum, optimizer_state_bytes_per_param, sgd)

__all__ = ["Optimizer", "adafactor", "adamw", "get_optimizer", "momentum",
           "optimizer_state_bytes_per_param", "sgd"]
