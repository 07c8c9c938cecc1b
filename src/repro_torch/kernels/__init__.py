"""Hand-written Hopper kernels of the port, each beside its plain version.

``minplus`` (K1) is ported.  The flash-attention and RWKV6 WKV kernels of
``repro.kernels`` serve only the language-model stack and are not ported
yet.
"""
