"""K3: the RWKV6 chunked WKV scan for Hopper.

``wkv6`` launches a hand-written CUDA kernel (``csrc/wkv6.cu``: pass 1 the
state entering each 64-token tile, pass 2 every tile's outputs at once) on
CUDA tensors and the plain chunked version ``wkv6_chunked_plain`` on CPU
tensors; ``wkv6_plain`` is the per-token recurrence, the oracle of both,
and ``wkv6_tiled_plain`` the kernel's decomposition in plain PyTorch.
"""

from .kernel import wkv6
from .ref import wkv6_chunked_plain, wkv6_plain, wkv6_tiled_plain

__all__ = ["wkv6", "wkv6_chunked_plain", "wkv6_plain", "wkv6_tiled_plain"]
