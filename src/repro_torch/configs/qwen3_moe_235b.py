"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8; qk_norm.  [hf:Qwen/Qwen3-30B-A3B; hf]
d_ff is the per-expert intermediate dim; every layer is MoE.  The port's
copy of ``repro/configs/qwen3_moe_235b.py``; one card holds a few of its
94 layers at full width (``BatchedServer(num_layers=...)``)."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536,
    vocab=151936, d_head=128, qk_norm=True, qkv_bias=False,
    tie_embeddings=False, ffn_mult=3, rope_theta=1e6,
    moe_experts=128, moe_top_k=8, moe_every=1, capacity_factor=1.25,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-235b-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=64, vocab=384,
        moe_experts=8, moe_top_k=2)
