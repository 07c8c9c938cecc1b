"""K3: the RWKV6 chunked WKV scan for Hopper, and K3', its backward.

``wkv6`` launches a hand-written CUDA kernel (``csrc/wkv6.cu``: pass 1 the
state entering each 64-token tile, pass 2 every tile's outputs at once) on
CUDA tensors and the plain chunked version ``wkv6_chunked_plain`` on CPU
tensors; ``wkv6_plain`` is the per-token recurrence, the oracle of both,
and ``wkv6_tiled_plain`` the kernel's decomposition in plain PyTorch.  With
grad it goes through ``WKV6``, whose backward is ``wkv6_bwd`` (K3',
``csrc/wkv6_bwd.cu``; plain versions ``wkv6_bwd_plain``, the per-token
reverse walk, and ``wkv6_bwd_tiled_plain``, the kernel's decomposition).
"""

from .kernel import WKV6, wkv6, wkv6_bwd
from .ref import (wkv6_bwd_plain, wkv6_bwd_tiled_plain, wkv6_chunked_plain,
                  wkv6_plain, wkv6_tiled_plain)

__all__ = ["WKV6", "wkv6", "wkv6_bwd", "wkv6_bwd_plain",
           "wkv6_bwd_tiled_plain", "wkv6_chunked_plain", "wkv6_plain",
           "wkv6_tiled_plain"]
