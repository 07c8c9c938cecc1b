"""Data pipeline: synthetic workloads + the paper's multi-client partition
(host numpy, bit-equal to the reference for the same seed)."""

from .synthetic import (ClientDataset, classification_batches,
                        client_datasets, dirichlet_partition,
                        token_lm_batches)

__all__ = ["ClientDataset", "classification_batches", "client_datasets",
           "dirichlet_partition", "token_lm_batches"]
