"""Device selection shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the
card.  The CPU is used only when the caller names it: a missing GPU is
an error, never a silent change of platform.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

__all__ = ["resolve_device", "refuse_dtensor"]


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


def refuse_dtensor(what: str, *tensors) -> None:
    """Raise if a DTensor reaches a kernel wrapper: the kernels take raw
    device pointers of whole local tensors, so a sharded call goes
    through ``local_map`` (``kernels/ops.py``), never straight here."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{what}: a DTensor reached the kernel wrapper; call it on the "
                "local shards through repro_torch.kernels.ops (local_map)"
            )
