"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors ``src/repro/`` module for module (``repro_torch/core/
shortest_path.py`` is the counterpart of ``repro/core/shortest_path.py``),
so each piece can be read beside the JAX reference it is held against.
The port imports ``torch`` and numpy only; it never imports ``jax`` or
anything of ``repro``.

Entry points (``Planner``, ``bcd_solve``, ``ours``, ``no_pipeline``,
``exhaustive_joint``, ``optimal``, ``rc_op``, ``rp_oc``,
``SplitLearningExecutor``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a GPU and without that explicit choice they raise.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
