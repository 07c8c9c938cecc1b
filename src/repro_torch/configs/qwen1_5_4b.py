"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20, i.e. MHA)
d_ff=6912 vocab=151936; QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
The port's copy of ``repro/configs/qwen1_5_4b.py``."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, n_heads=20, n_kv=20, d_ff=6912,
    vocab=151936, d_head=128, qk_norm=False, qkv_bias=True,
    tie_embeddings=False, ffn_mult=3, rope_theta=1e6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen1.5-4b-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=384)
