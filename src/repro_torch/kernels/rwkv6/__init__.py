"""K3: the RWKV6 chunked WKV scan for Hopper.

``wkv6`` launches a hand-written CUDA kernel (``csrc/wkv6.cu``, one thread
block per (batch x head, value-column tile)) on CUDA tensors and the plain
chunked version ``wkv6_chunked_plain`` on CPU tensors; ``wkv6_plain`` is
the per-token recurrence, the oracle of both.
"""

from .kernel import wkv6
from .ref import wkv6_chunked_plain, wkv6_plain

__all__ = ["wkv6", "wkv6_chunked_plain", "wkv6_plain"]
