"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2; Mamba:attn 7:1 interleave.
[arXiv:2403.19887; hf]  The port's copy of
``repro/configs/jamba_1_5_large.py``.

Period structure: 8 layers = 7 Mamba + 1 attention; MoE every 2nd layer.
One period holds 45.2B parameters (181 GB in float32), so one card serves
it at full width cut to a period of 2 layers
(``BatchedServer(config=dataclasses.replace(CONFIG, num_layers=2,
attn_every=2))``: a Mamba + SwiGLU slot and an attention + MoE slot)."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576,
    vocab=65536, d_head=128, qk_norm=False, qkv_bias=False,
    tie_embeddings=False, ffn_mult=3, use_rope=False,
    moe_experts=16, moe_top_k=2, moe_every=2, capacity_factor=1.25,
    attn_every=8, mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
    moe_ff_chunks=4, remat="dots", train_microbatches=8,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-1.5-large-reduced", num_layers=8, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=384,
        moe_experts=4, moe_top_k=2, attn_every=4)
