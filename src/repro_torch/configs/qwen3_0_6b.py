"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
Qwen3-family head_dim is 128 (q/k/v projections are wider than d_model).
The port's copy of ``repro/configs/qwen3_0_6b.py``."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072,
    vocab=151936, d_head=128, qk_norm=True, tie_embeddings=True,
    ffn_mult=3, rope_theta=1e6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-0.6b-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256)
