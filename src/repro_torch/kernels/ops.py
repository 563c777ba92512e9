"""Dispatch layer for the ported kernels: the model zoo's kernel path.

Each op dispatches on the device of its tensors: a CUDA tensor goes to
the hand-written kernel (or the call raises), a CPU tensor to the plain
torch version.  There is no switch between a plain path and a kernel
path on the card, and no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention
from .moe_gmm import moe_gmm
from .rglru import rglru_scan
from .ssd import chunk_cumsum, ssd_intra_chunk

__all__ = ["flash_attention", "moe_gmm", "ssd_chunked", "rglru_scan"]


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
    """Full SSD: the intra-chunk kernel, then the inter-chunk scan in torch.

    x (B, L, H, P), dt (B, L, H) float32, A (H,), Bm/Cm (B, L, G=1, N);
    ``init_state`` (B, H, P, N) seeds the scan (zeros when None; the
    kernel's outputs do not depend on it).  Returns (y (B, L, H, P),
    final_state (B, H, P, N)), both in ``x``'s dtype.  Padded tail rows
    carry ``dt = 0``, so they leave the state untouched.
    """
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if g != 1:
        raise ValueError(f"ssd_chunked takes one B/C group, got {g}")
    chunk = min(chunk, l)
    nb = -(-l // chunk)
    pad = nb * chunk - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(b, nb, chunk, h, p)
    dtc = dt.reshape(b, nb, chunk, h)
    Bc = Bm.reshape(b, nb, chunk, n)
    Cc = Cm.reshape(b, nb, chunk, n)
    y_intra, contrib, chunk_decay = ssd_intra_chunk(xc, dtc, A, Bc, Cc)

    # inter-chunk scan: carry the state, add y_inter per chunk
    ack = chunk_cumsum(dtc, A)                                       # (B,nb,C,H)
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    y_inter = torch.empty_like(y_intra)
    for k in range(nb):
        y_inter[:, k] = torch.einsum("bcn,bhpn,bch->bchp", Cc[:, k].float(), state,
                                     torch.exp(ack[:, k]))
        state = state * chunk_decay[:, k, :, None, None] + contrib[:, k]
    y = (y_intra + y_inter).reshape(b, nb * chunk, h, p)
    if pad:
        y = y[:, :l]
    return y.to(x.dtype), state.to(x.dtype)
