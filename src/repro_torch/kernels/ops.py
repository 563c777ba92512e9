"""Dispatch layer for the ported kernels: the model zoo's kernel path.

Each op dispatches on the device of its tensors: a CUDA tensor goes to
the hand-written kernel (or the call raises), a CPU tensor to the plain
torch version.  There is no switch between a plain path and a kernel
path on the card, and no fallback from one to the other.

``moe_gmm``, ``ssd_chunked`` and ``rglru_scan`` go through their autograd
Functions (``MoeGmmFn``, ``SsdIntraChunkFn``, ``RglruScanFn``: the forward
kernel, then the backward kernel) when grad is enabled and an input
requires grad, the train path; otherwise they launch the forward kernel
alone, so serving's launches and bits do not depend on autograd.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .flash_attention import FlashAttentionFn, flash_attention
from .moe_gmm import MoeGmmFn
from .moe_gmm import moe_gmm as _moe_gmm
from .rglru import RglruScanFn
from .rglru import rglru_scan as _rglru_scan
from .ssd import SsdIntraChunkFn, chunk_cumsum, ssd_intra_chunk

__all__ = ["flash_attention", "flash_attention_grad", "moe_gmm", "ssd_chunked", "rglru_scan"]


def flash_attention_grad(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                         q_offset=0, kv_offset=0, kv_valid_len=None):
    """:func:`flash_attention` that autograd differentiates: the forward
    kernel with the log-sum-exp, then the backward kernel
    (:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, softcap, scale, q_offset,
                                  kv_offset, kv_valid_len)


def _differentiated(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def moe_gmm(x, wg, wu, wd):
    """The expert FFN (:func:`~repro_torch.kernels.moe_gmm.moe_gmm`), through
    :class:`~repro_torch.kernels.moe_gmm.MoeGmmFn` when autograd records."""
    if _differentiated(x, wg, wu, wd):
        return MoeGmmFn.apply(x, wg, wu, wd)
    return _moe_gmm(x, wg, wu, wd)


def rglru_scan(x, r, i, lam, h0):
    """The RG-LRU scan (:func:`~repro_torch.kernels.rglru.rglru_scan`),
    through :class:`~repro_torch.kernels.rglru.RglruScanFn` when autograd
    records."""
    if _differentiated(x, r, i, lam, h0):
        return RglruScanFn.apply(x, r, i, lam, h0)
    return _rglru_scan(x, r, i, lam, h0)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
    """Full SSD: the intra-chunk kernel, then the inter-chunk scan in torch.

    x (B, L, H, P), dt (B, L, H) float32, A (H,), Bm/Cm (B, L, G=1, N);
    ``init_state`` (B, H, P, N) seeds the scan (zeros when None; the
    kernel's outputs do not depend on it).  Returns (y (B, L, H, P),
    final_state (B, H, P, N)), both in ``x``'s dtype.  Padded tail rows
    carry ``dt = 0``, so they leave the state untouched.  One chunk from a
    zero state skips the inter-chunk scan: its result is the kernel's.
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
    intra = (SsdIntraChunkFn.apply if _differentiated(xc, dtc, A, Bc, Cc)
             else ssd_intra_chunk)
    y_intra, contrib, chunk_decay = intra(xc, dtc, A, Bc, Cc)
    if nb == 1 and init_state is None:
        # one chunk from a zero state (every serve prefill): y_inter is
        # exactly 0 and the state exactly contrib (exp(acum) <= 1 is finite)
        return y_intra.reshape(b, l, h, p).to(x.dtype), contrib[:, 0].to(x.dtype)

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
