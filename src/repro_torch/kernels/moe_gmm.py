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

The backward (``csrc/moe_gmm_bwd.cu``, :func:`moe_gmm_bwd`) recomputes
``h``, ``u`` and ``a`` and returns ``(dx, dwg, dwu, dwd)`` in the inputs'
dtype, every product a float32 sum over a fixed order: in bf16 (D and F
multiples of 8, :func:`moe_bwd_path`) on the tensor cores, with ``dh``
and ``du`` rounded once to bf16 as the tensor cores' operands (as the
reference's bf16 gradient forms them); in float32 on the CUDA cores.
:class:`MoeGmmFn` wires forward and backward for autograd.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _cuda
from .._device import refuse_dtensor

__all__ = ["moe_bwd_path", "moe_gmm", "moe_gmm_oracle64", "moe_gmm_plain", "moe_gmm_bwd",
           "moe_gmm_bwd_plain", "MoeGmmFn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIG = {
    "moe_gmm": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]),
}
_BWD_SIG = {
    "moe_gmm_bwd": (ctypes.c_int, [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p]),
}
#: the backward's designs by the C entry point's ``path``
_BWD_DESIGNS = {"fma": 0, "mma": 1}


def moe_gmm_plain(x, wg, wu, wd):
    """The plain version, with the kernel's dtype rules."""
    acc = torch.promote_types(x.dtype, torch.float32)
    h = torch.bmm(x.to(acc), wg.to(acc))
    u = torch.bmm(x.to(acc), wu.to(acc))
    a = (F.silu(h) * u).to(wd.dtype)
    return torch.bmm(a.to(acc), wd.to(acc)).to(x.dtype)


def moe_gmm_bwd_plain(x, wg, wu, wd, dy):
    """The backward's plain version, written out: ``h``, ``u`` and ``g =
    dy wd^T`` recomputed in float32, ``a = cast(silu(h) u, wd.dtype)`` as the
    forward forms it, ``dh = g u silu'(h)``, ``du = g silu(h)``; returns
    ``(dx, dwg, dwu, dwd)`` in the inputs' dtypes."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, wgf, wuf, wdf, dyf = (t.to(acc) for t in (x, wg, wu, wd, dy))
    h = torch.bmm(xf, wgf)
    u = torch.bmm(xf, wuf)
    g = torch.bmm(dyf, wdf.transpose(1, 2))
    sig = torch.sigmoid(h)
    sh = F.silu(h)
    a = (sh * u).to(wd.dtype).to(acc)
    dh = g * u * (sig * (1 + h * (1 - sig)))
    du = g * sh
    dx = torch.bmm(dh, wgf.transpose(1, 2)) + torch.bmm(du, wuf.transpose(1, 2))
    xt = xf.transpose(1, 2)
    return (dx.to(x.dtype), torch.bmm(xt, dh).to(wg.dtype), torch.bmm(xt, du).to(wu.dtype),
            torch.bmm(a.transpose(1, 2), dyf).to(wd.dtype))


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


def _check(x, wg, wu, wd, what="moe_gmm"):
    """The kernels' operand rules; returns (E, C, D, F)."""
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in (wg, wu, wd)):
        raise TypeError(
            f"{what} takes float32 or bfloat16 x/wg/wu/wd of one dtype, got "
            f"{x.dtype} / {wg.dtype} / {wu.dtype} / {wd.dtype}"
        )
    if any(w.device != x.device for w in (wg, wu, wd)):
        raise ValueError(f"{what}: x and the weights lie on different devices")
    if x.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"want x (E, C, D) and wg (E, D, F), got "
                         f"{tuple(x.shape)} / {tuple(wg.shape)}")
    E, C, D = x.shape
    Fd = wg.shape[2]
    if (tuple(wg.shape) != (E, D, Fd) or tuple(wu.shape) != (E, D, Fd)
            or tuple(wd.shape) != (E, Fd, D)):
        raise ValueError(
            f"{what} shapes do not fit: x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
            f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}"
        )
    if E == 0 or C == 0 or D == 0 or Fd == 0:
        raise ValueError(f"empty {what}: E={E} C={C} D={D} F={Fd}")
    if not all(w.is_contiguous() for w in (wg, wu, wd)):
        raise ValueError(f"{what} takes contiguous weights")
    return E, C, D, Fd


def _moe_gmm_cuda(x, wg, wu, wd):
    """Launch ``csrc/moe_gmm.cu`` on the current stream."""
    E, C, D, Fd = _check(x, wg, wu, wd)
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
    refuse_dtensor("moe_gmm", x, wg, wu, wd)
    if x.device.type == "cuda":
        return _moe_gmm_cuda(x, wg, wu, wd)
    if x.device.type != "cpu":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    return moe_gmm_plain(x, wg, wu, wd)


moe_gmm.launches = 0


def moe_bwd_path(dtype, D: int, F: int, aligned: bool = True) -> str:
    """The backward kernel's design for one call: "mma" (bf16 on the
    tensor cores: D and F multiples of 8, 16-byte aligned operands) or
    "fma" (CUDA cores: float32, other shapes)."""
    return "mma" if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 and aligned else "fma"


def _bwd_checked(x, wg, wu, wd, dy, design=None):
    """The backward kernel's operand rules, checked before anything is
    built or launched; returns ``(E, C, D, F, path)``."""
    E, C, D, Fd = _check(x, wg, wu, wd, "moe_gmm_bwd")
    if dy.dtype != x.dtype or tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"moe_gmm_bwd: dy must be shaped, typed and placed as x "
                         f"{tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    aligned = all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, wg, wu, wd, dy))
    path = design or moe_bwd_path(x.dtype, D, Fd, aligned)
    if path not in _BWD_DESIGNS:
        raise ValueError(f"unknown moe_gmm_bwd design {path!r}")
    if path == "mma" and moe_bwd_path(x.dtype, D, Fd, aligned) != "mma":
        raise ValueError(f"the mma design takes 16-byte aligned bf16 with D and F multiples "
                         f"of 8, got {x.dtype} D={D} F={Fd}")
    return E, C, D, Fd, path


def _moe_gmm_bwd_cuda(x, wg, wu, wd, dy, design=None):
    """Launch ``csrc/moe_gmm_bwd.cu`` on the current stream, on the design
    :func:`moe_bwd_path` picks, or ``design``."""
    x, dy = x.contiguous(), dy.contiguous()
    E, C, D, Fd, path = _bwd_checked(x, wg, wu, wd, dy, design)
    lib = _cuda.load("moe_gmm_bwd", _BWD_SIG)
    dx, dwg, dwu, dwd = (torch.empty_like(t) for t in (x, wg, wu, wd))
    # scratch: bf16 on the tensor cores (their operands), float32 otherwise
    sdt = torch.bfloat16 if path == "mma" else torch.float32
    a, dh, du = torch.empty((3, E, C, Fd), dtype=sdt, device=x.device)
    err = lib.moe_gmm_bwd(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(),
        a.data_ptr(), dh.data_ptr(), du.data_ptr(), E, C, D, Fd, _DTYPES[x.dtype],
        _BWD_DESIGNS[path], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"moe_gmm_bwd launch failed: CUDA error {err}")
    moe_gmm_bwd.launches += 1
    return dx, dwg, dwu, dwd


def moe_gmm_bwd(x, wg, wu, wd, dy):
    """The expert FFN's backward on whatever device ``x`` lies on: the CUDA
    kernel for a CUDA tensor (raising if it cannot build or launch), the
    plain version for a CPU tensor.  Returns ``(dx, dwg, dwu, dwd)``.
    ``moe_gmm_bwd.launches`` counts kernel launches."""
    refuse_dtensor("moe_gmm_bwd", x, wg, wu, wd, dy)
    if x.device.type == "cuda":
        return _moe_gmm_bwd_cuda(x, wg, wu, wd, dy)
    if x.device.type != "cpu":
        raise ValueError(f"moe_gmm_bwd: unsupported device {x.device}")
    return moe_gmm_bwd_plain(x, wg, wu, wd, dy)


moe_gmm_bwd.launches = 0


class MoeGmmFn(torch.autograd.Function):
    """Differentiable expert FFN: the forward is :func:`moe_gmm`, the
    backward :func:`moe_gmm_bwd` (kernels for CUDA tensors, plain versions
    for CPU tensors).  Only the four inputs are kept between the two.

        out = MoeGmmFn.apply(x, wg, wu, wd)
    """

    @staticmethod
    def forward(ctx, x, wg, wu, wd):
        ctx.save_for_backward(x, wg, wu, wd)
        return moe_gmm(x, wg, wu, wd)

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wd = ctx.saved_tensors
        return moe_gmm_bwd(x, wg, wu, wd, dy)
