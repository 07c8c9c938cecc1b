"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; GQA, 128k vocab.  [arXiv:2407.21783; unverified]
The port's copy of ``repro/configs/llama3_8b.py``."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, d_head=128, qk_norm=False, qkv_bias=False,
    tie_embeddings=False, ffn_mult=3, rope_theta=5e5,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama3-8b-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=176, vocab=384)
