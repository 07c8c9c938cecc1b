"""K1: the masked min-plus / min-max DP sweep of Algorithm 1 for Hopper.

``sweep_minplus`` runs the full K-layer masked relaxation for a batch of
thresholds — of one graph, or each on its own graph of a stack
(``graph=``) — in one launch of a hand-written CUDA kernel
(``csrc/minplus.cu``) on CUDA tensors, and the plain PyTorch version
``sweep_plain`` on CPU tensors.
"""

from .kernel import sweep_minplus
from .ref import sweep_plain

__all__ = ["sweep_minplus", "sweep_plain"]
