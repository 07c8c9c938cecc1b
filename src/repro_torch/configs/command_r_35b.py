"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]
Cohere ties input/output embeddings; the 256k vocab makes the embedding +
head the dominant memory terms.  The port's copy of
``repro/configs/command_r_35b.py``; its reduced head size (8) reaches K2
and K2' zero-padded to 16."""

import dataclasses

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528,
    vocab=256000, d_head=128, qk_norm=False, qkv_bias=False,
    tie_embeddings=True, ffn_mult=3, rope_theta=8e6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="command-r-35b-reduced", num_layers=2, d_model=64,
        n_heads=8, n_kv=2, d_head=8, d_ff=192, vocab=512)
