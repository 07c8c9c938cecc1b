"""Arch registry of the port: ``get_config(arch_id, reduced=...)``.

Every architecture of the reference, under its id: the ``ssm`` family
(``rwkv6-1.6b``), the ``dense`` family (``qwen3-0.6b``, ``llama3-8b``,
``qwen1.5-4b``, ``command-r-35b``), the ``moe`` family
(``qwen3-moe-235b-a22b``, ``granite-moe-3b-a800m``), the ``vlm`` backbone
(``internvl2-1b``), the ``hybrid`` ``jamba-1.5-large-398b`` and the
``audio`` ``whisper-small``.
"""

from repro_torch.models.common import ArchConfig

from . import (command_r_35b, granite_moe_3b, internvl2_1b, jamba_1_5_large,
               llama3_8b, qwen1_5_4b, qwen3_0_6b, qwen3_moe_235b, rwkv6_1_6b,
               whisper_small)

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "command-r-35b": command_r_35b,
    "llama3-8b": llama3_8b,
    "qwen1.5-4b": qwen1_5_4b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "jamba-1.5-large-398b": jamba_1_5_large,
    "rwkv6-1.6b": rwkv6_1_6b,
    "internvl2-1b": internvl2_1b,
    "whisper-small": whisper_small,
}

ARCH_IDS = tuple(_MODULES)
CONFIGS = {name: mod.CONFIG for name, mod in _MODULES.items()}


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    mod = _MODULES.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    return mod.reduced() if reduced else mod.CONFIG


from .base import (SHAPE_NAMES, SHAPES, arch_profile, cache_specs,
                   count_params, input_specs, param_specs, runnable_cells,
                   supports_shape)

__all__ = ["ARCH_IDS", "ArchConfig", "CONFIGS", "SHAPES", "SHAPE_NAMES",
           "arch_profile", "cache_specs", "count_params", "get_config",
           "input_specs", "param_specs", "runnable_cells", "supports_shape"]
