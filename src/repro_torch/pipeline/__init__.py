"""Pipelined execution runtime of the port: schedule analytics, VGG and
stacked transformer stages, the micro-batched split-learning executor and
the SPMD stage pipeline across ranks (``spmd.py``)."""

from .schedule import (SimResult, memory_highwater, simulate,
                       simulate_from_breakdown)
from .stage import (VGGStage, split_vgg_params, stack_stage_params,
                    transformer_stage_fn, unstack_stage_params,
                    vgg_stages_from_cuts)
from .executor import (LinkHooks, SplitLearningExecutor, microbatch_grads,
                       split_batch)
from .spmd import (PipelineConfig, as_dtensors, make_pipelined_loss,
                   make_pipelined_train_step, param_shardings,
                   plan_to_pipeline_config, shard_params)

__all__ = [
    "SimResult", "memory_highwater", "simulate", "simulate_from_breakdown",
    "VGGStage", "split_vgg_params", "stack_stage_params",
    "transformer_stage_fn", "unstack_stage_params", "vgg_stages_from_cuts",
    "LinkHooks",
    "SplitLearningExecutor", "microbatch_grads", "split_batch",
    "PipelineConfig", "as_dtensors", "make_pipelined_loss",
    "make_pipelined_train_step", "param_shardings",
    "plan_to_pipeline_config", "shard_params",
]
