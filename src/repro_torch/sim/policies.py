"""Micro-batch admission policies — the part of ``repro/sim/policies.py``
that ``pipeline.schedule`` needs for its closed-form memory claims.

An :class:`AdmissionPolicy` assigns each pipeline stage an *admission
window*: the number of micro-batches allowed past that stage's forward
pass before the stage's own backward pass reclaims an activation.

* :class:`FIFO` — unbounded windows (GPipe-like): a stage can hold up to
  ``Q`` activations.
* :class:`OneFOneB` — window ``S - j`` at stage ``j`` of an ``S``-stage
  pipeline (1F1B).

The memory-budgeted policy and the engine-side edge generation wait for the
simulator's port.

>>> OneFOneB().stage_capacity(4, 8)
{0: 4, 1: 3, 2: 2, 3: 1}
>>> FIFO().stage_capacity(3, 8)
{0: 8, 1: 8, 2: 8}
"""

from __future__ import annotations


class AdmissionPolicy:
    """Strategy deciding when a micro-batch may enter each pipeline stage.

    A window of ``w`` at stage ``j`` bounds stage ``j``'s live activations
    by ``w``; ``None`` means unbounded.  Stages are numbered by position
    ``j`` in the chain of non-empty submodels (``0 .. S-1``).
    """

    name = "abstract"

    def window(self, num_stages: int, stage: int) -> int | None:
        raise NotImplementedError

    def stage_capacity(self, num_stages: int, num_microbatches: int) -> dict:
        """Claimed activation high-water mark per stage position, clipped
        by ``num_microbatches``."""
        out = {}
        for j in range(num_stages):
            w = self.window(num_stages, j)
            out[j] = (num_microbatches if w is None
                      else min(num_microbatches, w))
        return out


class FIFO(AdmissionPolicy):
    """GPipe-like admission: every micro-batch is admitted immediately."""

    name = "fifo"

    def window(self, num_stages: int, stage: int) -> int | None:
        return None


class OneFOneB(AdmissionPolicy):
    """1F1B admission: stage ``j`` of ``S`` holds at most ``S - j``
    activations."""

    name = "1f1b"

    def window(self, num_stages: int, stage: int) -> int | None:
        return num_stages - stage


_POLICIES = {"fifo": FIFO, "gpipe": FIFO, "1f1b": OneFOneB}


def resolve_policy(policy) -> AdmissionPolicy:
    """Accept a policy instance or one of the registered names
    (``"fifo"``/``"gpipe"``/``"1f1b"``)."""
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return _POLICIES[str(policy).lower()]()
    except KeyError:
        raise ValueError(
            f"unknown admission policy {policy!r}; expected one of "
            f"{sorted(_POLICIES)} or an AdmissionPolicy instance") from None
