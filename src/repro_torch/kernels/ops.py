"""Dispatch layer for the ported kernels: the model zoo's kernel path.

Each op dispatches on the device of its tensors: a CUDA tensor goes to
the hand-written kernel (or the call raises), a CPU tensor to the plain
torch version.  There is no switch between a plain path and a kernel
path on the card, and no fallback from one to the other.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .moe_gmm import moe_gmm

__all__ = ["flash_attention", "moe_gmm", "ssd_chunked", "rglru_scan"]


def ssd_chunked(*args, **kwargs):
    raise NotImplementedError(
        "ssd_chunked (Mamba-2 SSD) is not ported yet: ROADMAP B3 "
        "(mamba2_2p7b serving with the SSD kernel)"
    )


def rglru_scan(*args, **kwargs):
    raise NotImplementedError(
        "rglru_scan (RG-LRU) is not ported yet: ROADMAP B4 "
        "(recurrentgemma_9b serving with the RG-LRU kernel)"
    )
