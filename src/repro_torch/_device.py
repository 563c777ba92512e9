"""Device selection shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the
card.  The CPU is used only when the caller names it: a missing GPU is
an error, never a silent change of platform.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev
