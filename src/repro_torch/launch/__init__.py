"""Entry points of the port: ``train`` (the language-model trainer),
``steps`` (its step factories), ``serve`` (continuous-batching server),
``mesh`` (mesh layouts and DeviceMeshes), ``sharding`` (the partition
rules, their DTensor placements and a rank's "model" block), ``dryrun``
(one rank's step of every cell traced on fake tensors and a fake process
group) and ``roofline`` (the dry run's records against an H100's
data-sheet rates).  The names below load their module on first use, so
importing the package imports none of them."""

import importlib

_EXPORTS = {
    "fake_process_group": "dryrun", "run_cells": "dryrun",
    "active_params": "roofline", "load_records": "roofline",
    "markdown_table": "roofline", "model_flops": "roofline",
    "model_traffic_bytes": "roofline", "roofline_row": "roofline",
    "MeshLayout": "mesh", "build_mesh": "mesh", "mesh_tag": "mesh",
    "pipeline_layout": "mesh", "production_layout": "mesh",
    "ShardingPolicy": "sharding", "batch_sharding": "sharding",
    "cache_sharding": "sharding", "model_block": "sharding",
    "model_dim": "sharding", "opt_sharding_tree": "sharding",
    "param_sharding_tree": "sharding", "param_spec": "sharding",
    "make_train_step": "steps", "make_prefill_step": "steps",
    "make_decode_step": "steps", "default_microbatches": "steps",
    "default_optimizer_name": "steps",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
