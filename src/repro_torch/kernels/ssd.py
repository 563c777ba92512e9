"""Mamba-2 SSD intra-chunk part: the hand-written CUDA kernel
(``csrc/ssd_intra_chunk.cu``) for tensors on the card, its plain torch
version for tensors on the CPU.

For every (batch, chunk, head), with ``acum = cumsum(dt * A)`` over the
chunk::

    y_intra[t]  = sum_{s<=t} C_t.B_s exp(acum_t - acum_s) dt_s x_s
    contrib     = sum_s exp(acum_last - acum_s) dt_s B_s x_s^T   (state summary)
    chunk_decay = exp(acum_last)

all in float32.  ``ops.ssd_chunked`` runs the inter-chunk scan on top.

``acum`` is the float64 prefix sum of ``dt * A`` rounded once to float32
(:func:`chunk_cumsum`), in the kernel and in the plain version alike, so
both take the exp of the same float32 exponents.  At chunk 256 ``|acum|``
reaches a few hundred, where one float32 ulp is ~3e-5: a float32 prefix
sum in another order (the reference's ``jnp.cumsum``, torch's parallel
scan) moves each decay weight by up to ~3e-5 relative and ``y_intra`` by
~1e-3 absolute, which would swamp the kernel's own differences.
The wrapper makes every input contiguous (the model hands it slices);
the kernel allocates nothing and runs on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_plain", "chunk_cumsum"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C, _MAX_P, _MAX_N = 256, 128, 256

_SIG = {
    "ssd_intra_chunk": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]),
}


def chunk_cumsum(dt, A):
    """``cumsum(dt * A)`` over each chunk (dim 2 of ``(B, nb, C, H)``),
    summed in float64 and rounded once to float32, as the kernel forms it."""
    return torch.cumsum(dt.double() * A.double(), dim=2).float()


def ssd_intra_chunk_plain(x, dt, A, Bm, Cm):
    """The plain version: x (B, nb, C, H, P), dt (B, nb, C, H), A (H,),
    Bm/Cm (B, nb, C, N).  Returns (y_intra (B, nb, C, H, P), contrib
    (B, nb, H, P, N), chunk_decay (B, nb, H)), float32.  The exp of a
    masked (s > t) entry is never taken: its exponent is set to -inf."""
    c = x.shape[2]
    dt = dt.float()
    ack = chunk_cumsum(dt, A)                                         # (B,nb,C,H)
    seg = ack[:, :, :, None, :] - ack[:, :, None, :, :]               # (B,nb,t,s,H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    seg = seg.masked_fill(~causal[None, None, :, :, None], -float("inf"))
    cb = torch.einsum("bktn,bksn->bkts", Cm.float(), Bm.float())      # shared by heads
    w = cb[..., None] * torch.exp(seg) * dt[:, :, None, :, :]
    y = torch.einsum("bktsh,bkshp->bkthp", w, x.float())
    coef = dt * torch.exp(ack[:, :, -1:, :] - ack)                    # (B,nb,C,H)
    contrib = torch.einsum("bksh,bksn,bkshp->bkhpn", coef, Bm.float(), x.float())
    return y, contrib, torch.exp(ack[:, :, -1, :])


def _ssd_intra_chunk_cuda(x, dt, A, Bm, Cm):
    """Launch ``csrc/ssd_intra_chunk.cu`` on the current stream."""
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_intra_chunk takes float32 or bfloat16 x/Bm/Cm of one dtype, "
                        f"got {x.dtype} / {Bm.dtype} / {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_intra_chunk takes float32 dt and A, got {dt.dtype} / {A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd_intra_chunk: inputs lie on different devices")
    if x.dim() != 5:
        raise ValueError(f"want x (B, nb, C, H, P), got {tuple(x.shape)}")
    b, nb, c, h, p = x.shape
    n = Bm.shape[-1]
    if (tuple(dt.shape) != (b, nb, c, h) or tuple(A.shape) != (h,)
            or tuple(Bm.shape) != (b, nb, c, n) or tuple(Cm.shape) != (b, nb, c, n)):
        raise ValueError(f"ssd_intra_chunk shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)}")
    if (not 0 < c <= _MAX_C or not 0 < p <= _MAX_P or p & (p - 1)
            or not 0 < n <= _MAX_N or b * nb == 0 or h == 0):
        raise ValueError(f"ssd_intra_chunk takes 0 < C <= {_MAX_C}, P a power of two "
                         f"<= {_MAX_P}, 0 < N <= {_MAX_N}, got x {tuple(x.shape)}, N={n}")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    lib = _cuda.load("ssd_intra_chunk", _SIG)
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((b, nb, c, c), **f32)        # scratch: C.B^T per chunk
    y = torch.empty((b, nb, c, h, p), **f32)
    contrib = torch.empty((b, nb, h, p, n), **f32)
    decay = torch.empty((b, nb, h), **f32)
    err = lib.ssd_intra_chunk(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        cb.data_ptr(), y.data_ptr(), contrib.data_ptr(), decay.data_ptr(),
        b * nb, c, h, p, n, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed: CUDA error {err}")
    ssd_intra_chunk.launches += 1
    return y, contrib, decay


def ssd_intra_chunk(x, dt, A, Bm, Cm):
    """The intra-chunk SSD part on whatever device ``x`` lies on: the CUDA
    kernel for a CUDA tensor (raising if it cannot build or launch), the
    plain version for a CPU tensor.  ``ssd_intra_chunk.launches`` counts
    kernel launches."""
    if x.device.type == "cuda":
        return _ssd_intra_chunk_cuda(x, dt, A, Bm, Cm)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_intra_chunk: unsupported device {x.device}")
    return ssd_intra_chunk_plain(x, dt, A, Bm, Cm)


ssd_intra_chunk.launches = 0
