"""Arch registry of the port: ``get_config(arch_id, reduced=...)``.

The ``ssm`` family (``rwkv6-1.6b``), the ``dense`` family
(``qwen3-0.6b``, ``llama3-8b``, ``qwen1.5-4b``, ``command-r-35b``), the
``moe`` family (``qwen3-moe-235b-a22b``, ``granite-moe-3b-a800m``) and the
``vlm`` backbone (``internvl2-1b``) are ported, under the reference's ids;
the reference's other architectures (``jamba-1.5-large-398b``: hybrid;
``whisper-small``: audio) are ROADMAP Queue 1 item 10.
"""

from repro_torch.models.common import ArchConfig

from . import (command_r_35b, granite_moe_3b, internvl2_1b, llama3_8b,
               qwen1_5_4b, qwen3_0_6b, qwen3_moe_235b, rwkv6_1_6b)

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
    "command-r-35b": command_r_35b,
    "llama3-8b": llama3_8b,
    "qwen1.5-4b": qwen1_5_4b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "internvl2-1b": internvl2_1b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    mod = _MODULES.get(arch_id)
    if mod is None:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 item 10); "
            f"ported: {', '.join(ARCH_IDS)}")
    return mod.reduced() if reduced else mod.CONFIG


__all__ = ["ARCH_IDS", "ArchConfig", "get_config"]
