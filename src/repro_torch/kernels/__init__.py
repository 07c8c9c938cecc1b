"""Hand-written Hopper kernels of the port, each beside its plain version.

``minplus`` (K1, the min-plus DP sweep), ``flash`` (K2, the flash-attention
forward) and ``rwkv6`` (K3, the WKV6 scan): every Pallas kernel of
``repro.kernels`` has its counterpart here.
"""
