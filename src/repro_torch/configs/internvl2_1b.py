"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT + Qwen2-class LM backbone.  [arXiv:2404.16821; hf]
The ViT frontend is a stub: precomputed patch embeddings (B, 256, d_model)
are prepended to the token stream.  The port's copy of
``repro/configs/internvl2_1b.py``."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864,
    vocab=151655, d_head=64, qk_norm=False, qkv_bias=True,
    tie_embeddings=True, ffn_mult=3, rope_theta=1e6,
    patch_tokens=256,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-1b-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=384, patch_tokens=8)
