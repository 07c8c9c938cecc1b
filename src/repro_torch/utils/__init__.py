"""Tree helpers of the port (the reference's ``utils/hlo.py``, FLOPs and
collective bytes of a compiled step, is ROADMAP Queue 1 item 11b)."""

from .treemath import (global_norm, tree_add, tree_bytes, tree_leaves,
                       tree_map, tree_scale)

__all__ = ["global_norm", "tree_add", "tree_bytes", "tree_leaves",
           "tree_map", "tree_scale"]
