"""K2: the flash-attention forward for Hopper, and K2', its backward.

``flash_attention`` launches a hand-written CUDA kernel (``csrc/flash.cu``,
one thread block per (batch x head, 64-row query tile), an online softmax
over the key tiles) on CUDA tensors and the plain version
``attention_plain`` on CPU tensors.  With grad it goes through
``FlashAttention``, whose backward is ``flash_attention_bwd`` (K2',
``csrc/flash_bwd.cu``; plain version ``flash_bwd_plain``).
"""

from .kernel import FlashAttention, flash_attention, flash_attention_bwd
from .ref import attention_lse_plain, attention_plain, flash_bwd_plain

__all__ = ["FlashAttention", "attention_lse_plain", "attention_plain",
           "flash_attention", "flash_attention_bwd", "flash_bwd_plain"]
