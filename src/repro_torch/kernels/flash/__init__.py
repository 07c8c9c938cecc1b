"""K2: the flash-attention forward for Hopper.

``flash_attention`` launches a hand-written CUDA kernel (``csrc/flash.cu``,
one thread block per (batch x head, 64-row query tile), an online softmax
over the key tiles) on CUDA tensors and the plain version
``attention_plain`` on CPU tensors.
"""

from .kernel import flash_attention
from .ref import attention_plain

__all__ = ["attention_plain", "flash_attention"]
