"""GQA flash attention: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) for tensors on the card, its plain torch
version for tensors on the CPU.

The kernel computes the forward function of
:func:`repro_torch.models.common.chunked_attention` (the reference's
``models/common.py`` flash algorithm), which is also its plain version:
a query at ``q_offset + i`` attends to the key at ``kv_offset + j`` for
``j < kv_valid_len`` (or at ``kv_positions[j]``, a ring cache's map,
where a negative position marks an empty slot), causally and within
``window`` when ``window > 0``, with logits ``scale * q.k``
(softcapped when ``softcap > 0``).  Head dim up to 256.

The wrapper makes ``q`` contiguous (the model hands it a transposed
view) and ``kv_positions`` int32; ``k`` and ``v`` must be contiguous
already (the model passes one layer of the stacked KV cache, which is).
The kernel allocates nothing and runs on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _cuda
from ..models.common import chunked_attention

__all__ = ["flash_attention", "flash_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256

_SIG = {
    "flash_attention": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]),
}


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale: Optional[float] = None, q_offset=0,
                          kv_offset=0, kv_valid_len=None, kv_positions=None):
    """The plain version: blockwise online softmax in torch."""
    return chunked_attention(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        q_offset=q_offset, kv_offset=kv_offset, kv_valid_len=kv_valid_len,
        kv_positions=kv_positions,
    )


def _flash_attention_cuda(q, k, v, *, causal, window, softcap, scale,
                          q_offset, kv_offset, kv_valid_len, kv_positions=None):
    """Launch ``csrc/flash_attention.cu`` on the current stream."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype} / {k.dtype} / {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"want q (B, Hq, Lq, D) and k, v (B, Hkv, Lk, D), got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}"
        )
    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if not 0 < D <= _MAX_D or Lq == 0 or Lk == 0 or B == 0:
        raise ValueError(f"flash_attention takes 0 < D <= {_MAX_D} and non-empty "
                         f"q/k, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous k and v")
    valid = Lk if kv_valid_len is None else min(int(kv_valid_len), Lk)
    if valid < 1:
        raise ValueError(f"kv_valid_len must be >= 1, got {kv_valid_len}")
    kvp = None
    if kv_positions is not None:
        if (kv_positions.device != q.device or kv_positions.dtype.is_floating_point
                or tuple(kv_positions.shape) != (Lk,)):
            raise ValueError(f"kv_positions must be ({Lk},) integers on {q.device}, got "
                             f"{tuple(kv_positions.shape)} {kv_positions.dtype} on "
                             f"{kv_positions.device}")
        kvp = kv_positions.to(torch.int32).contiguous()
        valid = Lk
    q = q.contiguous()
    sc = scale if scale is not None else D ** -0.5
    lib = _cuda.load("flash_attention", _SIG)
    out = torch.empty_like(q)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kvp is None else kvp.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Lq, Lk, D,
        int(q_offset), int(kv_offset), valid,
        int(bool(causal)), int(window), float(softcap), float(sc),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale: Optional[float] = None, q_offset=0, kv_offset=0,
                    kv_valid_len=None, kv_positions=None):
    """Attention on whatever device ``q`` lies on: the CUDA kernel for a
    CUDA tensor (raising if it cannot build or launch), the plain
    version for a CPU tensor.  ``flash_attention.launches`` counts
    kernel launches."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, kv_offset=kv_offset, kv_valid_len=kv_valid_len,
              kv_positions=kv_positions)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_plain(q, k, v, **kw)


flash_attention.launches = 0
