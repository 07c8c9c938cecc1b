"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the default everywhere) requires a visible GPU and raises
    without one — the port never carries on quietly on the CPU.  Pass
    ``"cpu"`` to run the plain PyTorch paths on the host, as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
