"""whisper-small [audio] — 12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865; enc-dec, conv front end stubbed.  [arXiv:2212.04356;
unverified]  The port's copy of ``repro/configs/whisper_small.py``.
12 encoder + 12 decoder layers; the encoder takes precomputed frame
embeddings (B, 1500, d_model) where the conv stem would emit them."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=51865, d_head=64, qk_norm=False, qkv_bias=True,
    tie_embeddings=True, ffn_mult=2, use_rope=False,
    encoder_layers=12, encoder_frames=1500,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-small-reduced", num_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=384,
        encoder_layers=2, encoder_frames=16)
