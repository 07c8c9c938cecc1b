"""Pipelined execution runtime of the port: schedule analytics, VGG and
stacked transformer stages and the micro-batched split-learning executor.
The SPMD stage pipeline waits for ROADMAP Queue 1 item 11."""

from .schedule import (SimResult, memory_highwater, simulate,
                       simulate_from_breakdown)
from .stage import (VGGStage, split_vgg_params, stack_stage_params,
                    transformer_stage_fn, unstack_stage_params,
                    vgg_stages_from_cuts)
from .executor import (LinkHooks, SplitLearningExecutor, microbatch_grads,
                       split_batch)

__all__ = [
    "SimResult", "memory_highwater", "simulate", "simulate_from_breakdown",
    "VGGStage", "split_vgg_params", "stack_stage_params",
    "transformer_stage_fn", "unstack_stage_params", "vgg_stages_from_cuts",
    "LinkHooks",
    "SplitLearningExecutor", "microbatch_grads", "split_batch",
]
