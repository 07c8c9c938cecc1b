"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the default everywhere) requires a visible GPU and raises
    without one — the port never carries on quietly on the CPU.  Pass
    ``"cpu"`` to run the plain PyTorch paths on the host, as the tests do.
    Under a fake tensor mode (the dry run: shapes without data, nothing
    runs anywhere) ``"cuda"`` names fake CUDA tensors and needs no GPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and not _faking():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def _faking() -> bool:
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None
