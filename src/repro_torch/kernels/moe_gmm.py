"""MoE grouped matmul: the hand-written CUDA kernel (``csrc/moe_gmm.cu``)
for tensors on the card, its plain torch version for tensors on the CPU.

Batched expert FFN over capacity buckets::

    out[e] = cast(silu(x[e] @ wg[e]) * (x[e] @ wu[e]), wd.dtype) @ wd[e]

with float32 accumulation and float32 ``h``, ``u`` and ``a``; the output
takes ``x``'s dtype.  The wrapper makes ``x`` contiguous; the weights
must be contiguous already (the model passes one layer of the stacked
expert weights, which is).  In bf16 (D and F multiples of 8) the kernel
runs on the tensor cores, weights streamed through a cp.async ring; in
float32 on the CUDA cores (no TF32).  Its float32 sums run in another
order than ``torch.bmm``'s, so in bf16 an ``a`` near a rounding boundary
may round the other way than the plain version's.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda

__all__ = ["moe_gmm", "moe_gmm_oracle64", "moe_gmm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIG = {
    "moe_gmm": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]),
}


def moe_gmm_plain(x, wg, wu, wd):
    """The plain version, with the kernel's dtype rules."""
    h = torch.bmm(x.float(), wg.float())
    u = torch.bmm(x.float(), wu.float())
    a = (F.silu(h) * u).to(wd.dtype)
    return torch.bmm(a.float(), wd.float()).to(x.dtype)


def moe_gmm_oracle64(x, wg, wu, wd):
    """The plain version with ``h``, ``u`` and ``out`` summed in float64,
    each rounded once to float32: the sums that the kernel's and
    ``moe_gmm_plain``'s float32 sums both approximate.  An oracle for the
    checks (bf16 products are exact in float64, so only the sums of up to
    D or F terms round), not a path of the model."""
    d = torch.float64
    h = torch.bmm(x.to(d), wg.to(d)).float()
    u = torch.bmm(x.to(d), wu.to(d)).float()
    a = (F.silu(h) * u).to(wd.dtype)
    return torch.bmm(a.to(d), wd.to(d)).float().to(x.dtype)


def _moe_gmm_cuda(x, wg, wu, wd):
    """Launch ``csrc/moe_gmm.cu`` on the current stream."""
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in (wg, wu, wd)):
        raise TypeError(
            f"moe_gmm takes float32 or bfloat16 x/wg/wu/wd of one dtype, got "
            f"{x.dtype} / {wg.dtype} / {wu.dtype} / {wd.dtype}"
        )
    if any(w.device != x.device for w in (wg, wu, wd)):
        raise ValueError("moe_gmm: x and the weights lie on different devices")
    if x.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"want x (E, C, D) and wg (E, D, F), got "
                         f"{tuple(x.shape)} / {tuple(wg.shape)}")
    E, C, D = x.shape
    Fd = wg.shape[2]
    if (tuple(wg.shape) != (E, D, Fd) or tuple(wu.shape) != (E, D, Fd)
            or tuple(wd.shape) != (E, Fd, D)):
        raise ValueError(
            f"moe_gmm shapes do not fit: x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
            f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}"
        )
    if E == 0 or C == 0 or D == 0 or Fd == 0:
        raise ValueError(f"empty moe_gmm: E={E} C={C} D={D} F={Fd}")
    if not all(w.is_contiguous() for w in (wg, wu, wd)):
        raise ValueError("moe_gmm takes contiguous weights")
    x = x.contiguous()
    lib = _cuda.load("moe_gmm", _SIG)
    out = torch.empty_like(x)
    err = lib.moe_gmm(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
        E, C, D, Fd, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"moe_gmm launch failed: CUDA error {err}")
    moe_gmm.launches += 1
    return out


def moe_gmm(x, wg, wu, wd):
    """The expert FFN on whatever device ``x`` lies on: the CUDA kernel
    for a CUDA tensor (raising if it cannot build or launch), the plain
    version for a CPU tensor.  ``moe_gmm.launches`` counts kernel
    launches."""
    if x.device.type == "cuda":
        return _moe_gmm_cuda(x, wg, wu, wd)
    if x.device.type != "cpu":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    return moe_gmm_plain(x, wg, wu, wd)


moe_gmm.launches = 0
