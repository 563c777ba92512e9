"""Fused RG-LRU scan: the hand-written CUDA kernel (``csrc/rglru_scan.cu``)
for tensors on the card, its plain torch version for tensors on the CPU.

Gates and the linear recurrence in one pass, in float32::

    a_t = exp(-8 softplus(lam) sigmoid(r_t))
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t

``r`` and ``i`` are the gates' pre-activations.  Returns ``(h (B, L, W),
h_T (B, W))`` in float32.  The wrapper copies only operands the kernel
cannot read as they are (non-contiguous x / r / i; lam other than
float32; h0 other than float32 or bfloat16); the kernel allocates nothing
and runs on PyTorch's current stream.  At L = 1, h_T is a view of h.

The backward (``csrc/rglru_scan_bwd.cu``, :func:`rglru_scan_bwd`) runs the
reverse scan ``g_t = dh_t + a_{t+1} g_{t+1}`` from the saved output and
returns ``(dx, dr, di, dlam, dh0)``; :class:`RglruScanFn` wires forward and
backward for autograd.  Its plan (:func:`rglru_bwd_path`) sends bf16 of a
width that is a multiple of 8 to the vectorised chunk lanes and the rest to
the first, one-channel-a-thread design.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from .._device import refuse_dtensor

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_bwd", "rglru_scan_bwd_plain",
           "RglruScanFn", "rglru_bwd_path"]

_C = 8.0
_F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIG = {
    "rglru_scan": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]),
}
_BWD_SIG = {
    "rglru_scan_bwd": (ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}
#: the backward's designs by the C entry point's ``path``
_BWD_DESIGNS = {"scalar": 0, "vec": 1}


def _softplus(x):
    """``logaddexp(x, 0)``, the reference's softplus."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def rglru_scan_plain(x, r, i, lam, h0):
    """The plain version: the gates vectorised, then the recurrence as a
    loop over L."""
    acc = torch.promote_types(x.dtype, torch.float32)
    log_a = -_C * _softplus(lam.to(acc)) * torch.sigmoid(r.to(acc))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * torch.sigmoid(i.to(acc)) * x.to(acc)
    h = h0.to(acc)
    out = torch.empty_like(b)
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def rglru_scan_bwd_plain(x, r, i, lam, h0, out, dh, dh_t=None):
    """The backward's plain version, written out: the reverse scan
    ``g_t = dh_t + a_{t+1} g_{t+1}`` (``dh_t`` of h_T added at the last
    step), then ``da_t = g_t h_{t-1}`` from the saved ``out`` and the chain
    through the sigmoids, ``sqrt(max(1 - a^2, 1e-12))`` and ``softplus(lam)``.
    Returns ``(dx, dr, di, dlam, dh0)``: dx / dr / di in x's dtype, dlam and
    dh0 in float32 (float64 for float64 inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, lamf = x.to(acc), lam.to(acc)
    sr, si = torch.sigmoid(r.to(acc)), torch.sigmoid(i.to(acc))
    ncs = -_C * _softplus(lamf)
    log_a = ncs * sr
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    z = 1.0 - e2
    beta = torch.sqrt(torch.clamp(z, min=1e-12))
    g = torch.empty_like(xf)
    run = dh[:, -1].to(acc) + (dh_t.to(acc) if dh_t is not None else 0.0)
    g[:, -1] = run
    for t in range(x.shape[1] - 2, -1, -1):
        run = dh[:, t].to(acc) + a[:, t + 1] * run
        g[:, t] = run
    h_prev = torch.cat([h0.to(acc)[:, None], out[:, :-1].to(acc)], dim=1)
    dbeta = torch.where(z > 1e-12, -e2 / beta, torch.zeros_like(z))
    dlog_a = g * h_prev * a + g * si * xf * dbeta
    dx = g * beta * si
    di = g * beta * xf * si * (1 - si)
    dr = dlog_a * ncs * sr * (1 - sr)
    dlam = (dlog_a * sr).sum(dim=(0, 1)) * (-_C * torch.sigmoid(lamf))
    return dx.to(x.dtype), dr.to(r.dtype), di.to(i.dtype), dlam, a[:, 0] * g[:, 0]


_FN = []


def _fn():
    """The kernel's entry point, built and loaded at first use."""
    if not _FN:
        _FN.append(_cuda.load("rglru_scan", _SIG).rglru_scan)
    return _FN[0]


# The launcher reads each attribute once and copies nothing that is
# already in the kernel's layout: the decode step calls it once per LRU
# layer, so its host time is part of the step's.
def _rglru_scan_cuda(x, r, i, lam, h0):
    """Launch ``csrc/rglru_scan.cu`` on the current stream."""
    dtype = x.dtype
    code = _DTYPES.get(dtype)
    if code is None or r.dtype is not dtype or i.dtype is not dtype:
        raise TypeError(f"rglru_scan takes float32 or bfloat16 x/r/i of one dtype, "
                        f"got {dtype} / {r.dtype} / {i.dtype}")
    if not (lam.dtype.is_floating_point and h0.dtype.is_floating_point):
        raise TypeError(f"rglru_scan takes floating lam and h0, got {lam.dtype} / {h0.dtype}")
    shape = x.shape
    if len(shape) != 3:
        raise ValueError(f"want x (B, L, W), got {tuple(shape)}")
    b, l, w = shape
    if r.shape != shape or i.shape != shape or lam.shape != (w,) or h0.shape != (b, w):
        raise ValueError(f"rglru_scan shapes do not fit: x {tuple(shape)}, r "
                         f"{tuple(r.shape)}, i {tuple(i.shape)}, lam {tuple(lam.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    dev = x.get_device()
    if not (r.get_device() == i.get_device() == lam.get_device() == h0.get_device() == dev):
        raise ValueError("rglru_scan: inputs lie on different devices")
    if b * l * w == 0:
        raise ValueError(f"empty rglru_scan: x {tuple(shape)}")
    if not (x.is_contiguous() and r.is_contiguous() and i.is_contiguous()):
        x, r, i = x.contiguous(), r.contiguous(), i.contiguous()
    if lam.dtype is not _F32 or not lam.is_contiguous():
        lam = lam.float().contiguous()
    h0_code = _DTYPES.get(h0.dtype)
    if h0_code is None or not h0.is_contiguous():
        h0, h0_code = h0.float().contiguous(), 0
    out = torch.empty(shape, dtype=_F32, device=x.device)
    # h_T is out[:, L - 1]; at L = 1 that is a contiguous (B, W) view
    h_t = out[:, 0] if l == 1 else torch.empty((b, w), dtype=_F32, device=x.device)
    err = _fn()(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), h0.data_ptr(), h0_code,
        out.data_ptr(), None if l == 1 else h_t.data_ptr(), b, l, w, code,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return out, h_t


def rglru_scan(x, r, i, lam, h0):
    """The RG-LRU scan on whatever device ``x`` lies on: the CUDA kernel for
    a CUDA tensor (raising if it cannot build or launch), the plain version
    for a CPU tensor.  ``rglru_scan.launches`` counts kernel launches."""
    refuse_dtensor("rglru_scan", x, r, i, lam, h0)
    if x.device.type == "cuda":
        return _rglru_scan_cuda(x, r, i, lam, h0)
    if x.device.type != "cpu":
        raise ValueError(f"rglru_scan: unsupported device {x.device}")
    return rglru_scan_plain(x, r, i, lam, h0)


rglru_scan.launches = 0


def rglru_bwd_path(dtype, W: int, aligned: bool = True) -> str:
    """The backward kernel's design for one call: "vec" (bf16, W a multiple
    of 8, 16-byte aligned operands: 8 channels a thread on 16-byte loads)
    or "scalar" (the first design: float32, other widths)."""
    return "vec" if dtype == torch.bfloat16 and W % 8 == 0 and aligned else "scalar"


def _bwd_checked(x, r, i, lam, h0, out, dh, dh_t=None, design=None):
    """The backward kernel's operand rules, checked before anything is
    built or launched; returns ``(B, L, W)``."""
    dtype = x.dtype
    if _DTYPES.get(dtype) is None or r.dtype is not dtype or i.dtype is not dtype:
        raise TypeError(f"rglru_scan_bwd takes float32 or bfloat16 x/r/i of one dtype, "
                        f"got {dtype} / {r.dtype} / {i.dtype}")
    shape = x.shape
    if len(shape) != 3 or r.shape != shape or i.shape != shape:
        raise ValueError(f"want x, r, i (B, L, W), got {tuple(shape)} / {tuple(r.shape)} / "
                         f"{tuple(i.shape)}")
    b, l, w = shape
    if (lam.shape != (w,) or h0.shape != (b, w) or out.shape != shape or dh.shape != shape
            or (dh_t is not None and dh_t.shape != (b, w))):
        raise ValueError(f"rglru_scan_bwd shapes do not fit x {tuple(shape)}: lam "
                         f"{tuple(lam.shape)}, h0 {tuple(h0.shape)}, out {tuple(out.shape)}, "
                         f"dh {tuple(dh.shape)}")
    if b * l * w == 0:
        raise ValueError(f"empty rglru_scan_bwd: x {tuple(shape)}")
    if design is not None and design not in _BWD_DESIGNS:
        raise ValueError(f"unknown rglru_scan_bwd design {design!r}")
    if design == "vec" and rglru_bwd_path(dtype, w) != "vec":
        raise ValueError(f"the vec design takes bf16 with W a multiple of 8, got {dtype} W={w}")
    return b, l, w


def _rglru_scan_bwd_cuda(x, r, i, lam, h0, out, dh, dh_t=None, design=None):
    """Launch ``csrc/rglru_scan_bwd.cu`` on the current stream, on the
    design :func:`rglru_bwd_path` picks, or ``design``: the reverse chunked
    scan and the batch sum of dlam."""
    b, l, w = _bwd_checked(x, r, i, lam, h0, out, dh, dh_t, design)
    dev = x.get_device()
    ts = [r, i, lam, h0, out, dh] + ([dh_t] if dh_t is not None else [])
    if any(t.get_device() != dev for t in ts):
        raise ValueError("rglru_scan_bwd: inputs lie on different devices")
    x, r, i = x.contiguous(), r.contiguous(), i.contiguous()
    lam = lam.float().contiguous()
    h0_code = _DTYPES.get(h0.dtype)
    if h0_code is None:
        h0, h0_code = h0.float(), 0
    h0 = h0.contiguous()
    # float32 and contiguous already on the train path: no copy
    out, dh = out.float().contiguous(), dh.float().contiguous()
    if dh_t is not None:
        dh_t = dh_t.float().contiguous()
    dx, dr, di = (torch.empty((b, l, w), dtype=x.dtype, device=x.device) for _ in range(3))
    f32 = dict(dtype=_F32, device=x.device)
    dh0, dlam_part = torch.empty((2, b, w), **f32)
    dlam = torch.empty((w,), **f32)
    ops_ = (x, r, i, h0, out, dh, dx, dr, di, dh0) + ((dh_t,) if dh_t is not None else ())
    path = design or rglru_bwd_path(x.dtype, w, all(t.data_ptr() % 16 == 0 for t in ops_))
    fn = _cuda.load("rglru_scan_bwd", _BWD_SIG).rglru_scan_bwd
    err = fn(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), h0.data_ptr(), h0_code,
        out.data_ptr(), dh.data_ptr(), None if dh_t is None else dh_t.data_ptr(),
        dx.data_ptr(), dr.data_ptr(), di.data_ptr(), dh0.data_ptr(), dlam_part.data_ptr(),
        dlam.data_ptr(), b, l, w, _DTYPES[x.dtype], _BWD_DESIGNS[path],
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: CUDA error {err}")
    rglru_scan_bwd.launches += 1
    return dx, dr, di, dlam, dh0


def rglru_scan_bwd(x, r, i, lam, h0, out, dh, dh_t=None):
    """The RG-LRU scan's backward on whatever device ``x`` lies on: the CUDA
    kernel for a CUDA tensor (raising if it cannot build or launch), the
    plain version for a CPU tensor.  ``out`` is the forward's h, ``dh`` and
    ``dh_t`` the gradients of h and h_T (``dh_t`` may be None).  Returns
    ``(dx, dr, di, dlam, dh0)``.  ``rglru_scan_bwd.launches`` counts kernel
    launches."""
    refuse_dtensor("rglru_scan_bwd", x, r, i, lam, h0, out, dh, dh_t)
    if x.device.type == "cuda":
        return _rglru_scan_bwd_cuda(x, r, i, lam, h0, out, dh, dh_t)
    if x.device.type != "cpu":
        raise ValueError(f"rglru_scan_bwd: unsupported device {x.device}")
    return rglru_scan_bwd_plain(x, r, i, lam, h0, out, dh, dh_t)


rglru_scan_bwd.launches = 0


class RglruScanFn(torch.autograd.Function):
    """Differentiable RG-LRU scan: the forward is :func:`rglru_scan`, the
    backward :func:`rglru_scan_bwd` (kernels for CUDA tensors, plain
    versions for CPU tensors).  The inputs and the output h are kept
    between the two; h_T is returned as a tensor of its own.

        h, h_T = RglruScanFn.apply(x, r, i, lam, h0)
    """

    @staticmethod
    def forward(ctx, x, r, i, lam, h0):
        out, h_t = rglru_scan(x, r, i, lam, h0)
        if h_t._base is out:
            h_t = h_t.clone()
        ctx.save_for_backward(x, r, i, lam, h0, out)
        ctx.set_materialize_grads(False)
        return out, h_t

    @staticmethod
    def backward(ctx, dh, dh_t):
        x, r, i, lam, h0, out = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(out)
        dx, dr, di, dlam, dh0 = rglru_scan_bwd(x, r, i, lam, h0, out, dh, dh_t)
        return dx, dr, di, dlam.to(lam.dtype), dh0.to(h0.dtype)
