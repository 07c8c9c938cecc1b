"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
The assignment text says both "MoE 40e" and "32 experts"; the reference
follows the config line (40 experts), and so does the port.  The port's
copy of ``repro/configs/granite_moe_3b.py``."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512,
    vocab=49155, d_head=64, qk_norm=False, qkv_bias=False,
    tie_embeddings=True, ffn_mult=3, rope_theta=1e4,
    moe_experts=40, moe_top_k=8, moe_every=1, capacity_factor=1.25,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-3b-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=64, vocab=384,
        moe_experts=5, moe_top_k=2)
