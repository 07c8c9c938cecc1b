"""Hand-written Hopper kernels of the port, each beside its plain version.

``minplus`` (K1) and ``rwkv6`` (K3, the WKV6 scan) are ported.  The
flash-attention kernel of ``repro.kernels`` has no caller in the reference
and is not ported yet.
"""
