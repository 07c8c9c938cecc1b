"""VLM backbone (``internvl2-1b``): the transformer LM with a stubbed ViT
front end — the port of ``repro/models/vlm.py``.

Only the transformer backbone is modeled, as in the reference: the vision
encoder is a stub whose output, precomputed patch embeddings (B,
``patch_tokens``, d_model), comes in with the batch.  The patches are
prepended to the token embeddings; the loss is taken on the text
positions only.  Decode is the plain transformer's (the patches sit at the
head of the KV cache after the prefill).
"""

from __future__ import annotations

from . import transformer as tf

init_params = tf.init_params
make_cache = tf.make_cache
decode_step = tf.decode_step
loss_fn = tf.loss_fn            # reads batch["patch_embeds"]


def prefill(model: tf.Transformer, tokens, patch_embeds, cache_len: int):
    """The prompt after its ``patch_embeds`` (B, P, d), from position 0;
    returns (last-position logits, cache holding P + S positions)."""
    return tf.prefill(model, tokens, cache_len, extra_embeds=patch_embeds)


__all__ = ["decode_step", "init_params", "loss_fn", "make_cache", "prefill"]
