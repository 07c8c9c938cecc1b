"""Synthetic data substrate — the port's copy of ``repro/data/synthetic.py``.

CIFAR-10/MNIST are not available offline; the classification stream keeps
their tensor shapes (32x32x3 NHWC, 10 classes) with a *learnable* structure
(class-conditional means + noise) so accuracy curves are meaningful, and
the LM stream generates a Zipf-ish token process with a planted bigram
structure so loss decreases measurably.  The multi-client split implements
IID and non-IID (Dirichlet over class proportions) partitions — the paper's
Fig. 4 settings.  Host numpy, bit-equal to the reference for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def token_lm_batches(*, batch: int, seq_len: int, vocab: int, seed: int = 0,
                     bigram_rank: int = 64) -> Iterator[dict]:
    """Endless stream of {tokens, labels} with a planted low-rank bigram."""
    rng = np.random.default_rng(seed)
    # planted transition structure: token t+1 ~ f(token t mod rank)
    table = rng.integers(0, vocab, size=(bigram_rank, 8))
    while True:
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        noise = rng.random((batch, seq_len))
        choice = rng.integers(0, 8, size=(batch, seq_len))
        rand_tok = rng.integers(0, vocab, size=(batch, seq_len))
        for t in range(seq_len):
            follow = table[toks[:, t] % bigram_rank, choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, follow,
                                      rand_tok[:, t])
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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


# ---------------------------------------------------------------------------
# Multi-client partitioning (Sec. III-A: M clients hold the data)
# ---------------------------------------------------------------------------

def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0) -> list:
    """Non-IID split: per-class Dirichlet proportions across clients.
    alpha -> inf recovers IID.  Returns list of index arrays."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    out = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        splits = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, splits)):
            out[cl].append(part)
    return [np.concatenate(parts) if parts else np.array([], np.int64)
            for parts in out]


@dataclasses.dataclass
class ClientDataset:
    """One client's shard, serving b_m-sized micro-batch draws (Eq. 1)."""
    images: np.ndarray
    labels: np.ndarray
    rng: np.random.Generator

    def draw(self, n: int) -> dict:
        idx = self.rng.integers(0, len(self.labels), size=n)
        return {"images": self.images[idx], "labels": self.labels[idx]}


def client_datasets(num_clients: int, *, samples: int = 4096,
                    iid: bool = True, alpha: float = 0.5, seed: int = 0
                    ) -> list:
    """Materialize a synthetic CIFAR-shaped dataset split across clients."""
    gen = classification_batches(batch=samples, seed=seed)
    full = next(gen)
    if iid:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(samples)
        shards = np.array_split(idx, num_clients)
    else:
        shards = dirichlet_partition(full["labels"], num_clients, alpha,
                                     seed)
    return [ClientDataset(full["images"][s], full["labels"][s],
                          np.random.default_rng(seed + 1 + i))
            for i, s in enumerate(shards)]
