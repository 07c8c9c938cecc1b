"""Tree helpers of the port and a step's cost per device
(``utils/cost.py``, the counterpart of the reference's ``utils/hlo.py``)."""

from .cost import (CollectiveStats, CostCounter, StepCost, charge,
                   op_histogram, step_cost, tensor_bytes)
from .treemath import (global_norm, tree_add, tree_bytes, tree_leaves,
                       tree_map, tree_scale)

__all__ = ["CollectiveStats", "CostCounter", "StepCost", "charge",
           "global_norm", "op_histogram", "step_cost", "tensor_bytes",
           "tree_add", "tree_bytes", "tree_leaves", "tree_map", "tree_scale"]
