"""rwkv6-1.6b "Finch" [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; data-dependent decay.  [arXiv:2404.05892; unverified]
The port's copy of ``repro/configs/rwkv6_1_6b.py``."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168,
    vocab=65536, rwkv_head_dim=64, use_rope=False, ffn_mult=2,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-1.6b-reduced", num_layers=2, d_model=64,
        n_heads=2, n_kv=2, d_ff=128, vocab=384, rwkv_head_dim=32)
