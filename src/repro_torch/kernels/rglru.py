"""Fused RG-LRU scan: the hand-written CUDA kernel (``csrc/rglru_scan.cu``)
for tensors on the card, its plain torch version for tensors on the CPU.

Gates and the linear recurrence in one pass, in float32::

    a_t = exp(-8 softplus(lam) sigmoid(r_t))
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t

``r`` and ``i`` are the gates' pre-activations.  Returns ``(h (B, L, W),
h_T (B, W))`` in float32.  The wrapper makes the inputs contiguous and
widens ``lam`` and ``h0`` to float32; the kernel allocates nothing and
runs on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda

__all__ = ["rglru_scan", "rglru_scan_plain"]

_C = 8.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIG = {
    "rglru_scan": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]),
}


def _softplus(x):
    """``logaddexp(x, 0)``, the reference's softplus."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def rglru_scan_plain(x, r, i, lam, h0):
    """The plain version: the gates vectorised, then the recurrence as a
    loop over L."""
    log_a = -_C * _softplus(lam.float()) * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * torch.sigmoid(i.float()) * x.float()
    h = h0.float()
    out = torch.empty_like(b)
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def _rglru_scan_cuda(x, r, i, lam, h0):
    """Launch ``csrc/rglru_scan.cu`` on the current stream."""
    if x.dtype not in _DTYPES or r.dtype != x.dtype or i.dtype != x.dtype:
        raise TypeError(f"rglru_scan takes float32 or bfloat16 x/r/i of one dtype, "
                        f"got {x.dtype} / {r.dtype} / {i.dtype}")
    if not (lam.dtype.is_floating_point and h0.dtype.is_floating_point):
        raise TypeError(f"rglru_scan takes floating lam and h0, got {lam.dtype} / {h0.dtype}")
    if any(t.device != x.device for t in (r, i, lam, h0)):
        raise ValueError("rglru_scan: inputs lie on different devices")
    if x.dim() != 3:
        raise ValueError(f"want x (B, L, W), got {tuple(x.shape)}")
    b, l, w = x.shape
    if (tuple(r.shape) != (b, l, w) or tuple(i.shape) != (b, l, w)
            or tuple(lam.shape) != (w,) or tuple(h0.shape) != (b, w)):
        raise ValueError(f"rglru_scan shapes do not fit: x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}, i {tuple(i.shape)}, lam {tuple(lam.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    if b * l * w == 0:
        raise ValueError(f"empty rglru_scan: x {tuple(x.shape)}")
    x, r, i = x.contiguous(), r.contiguous(), i.contiguous()
    lam, h0 = lam.float().contiguous(), h0.float().contiguous()
    lib = _cuda.load("rglru_scan", _SIG)
    out = torch.empty((b, l, w), dtype=torch.float32, device=x.device)
    h_t = torch.empty((b, w), dtype=torch.float32, device=x.device)
    err = lib.rglru_scan(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), h0.data_ptr(),
        out.data_ptr(), h_t.data_ptr(), b, l, w, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return out, h_t


def rglru_scan(x, r, i, lam, h0):
    """The RG-LRU scan on whatever device ``x`` lies on: the CUDA kernel for
    a CUDA tensor (raising if it cannot build or launch), the plain version
    for a CPU tensor.  ``rglru_scan.launches`` counts kernel launches."""
    if x.device.type == "cuda":
        return _rglru_scan_cuda(x, r, i, lam, h0)
    if x.device.type != "cpu":
        raise ValueError(f"rglru_scan: unsupported device {x.device}")
    return rglru_scan_plain(x, r, i, lam, h0)


rglru_scan.launches = 0
