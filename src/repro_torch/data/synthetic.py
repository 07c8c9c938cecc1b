"""Synthetic data substrate — the port's copy of the classification stream
of ``repro/data/synthetic.py``.

CIFAR-10 is not available offline; the stream keeps its tensor shapes
(32x32x3 NHWC, 10 classes) with a *learnable* structure (class-conditional
means + noise).  Host numpy, bit-equal to the reference for the same seed.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def classification_batches(*, batch: int, num_classes: int = 10,
                           image_hw: int = 32, channels: int = 3,
                           seed: int = 0, noise: float = 0.35
                           ) -> Iterator[dict]:
    """CIFAR-shaped learnable stream: class mean images + Gaussian noise."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 1.0, (num_classes, image_hw, image_hw, channels))
    while True:
        labels = rng.integers(0, num_classes, size=batch)
        imgs = means[labels] + rng.normal(0, noise,
                                          (batch, image_hw, image_hw,
                                           channels))
        yield {"images": imgs.astype(np.float32),
               "labels": labels.astype(np.int32)}
