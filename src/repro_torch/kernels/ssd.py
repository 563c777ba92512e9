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
The wrapper's plan (:func:`ssd_plan`) sends bf16 to the tensor cores and
float32 to the CUDA cores.  x, B and C are read in place as token rows
with a row stride (the model hands it slices of one projection) where the
path can; the kernel allocates nothing and runs on PyTorch's current
stream.

The backward (``csrc/ssd_intra_chunk_bwd.cu``, :func:`ssd_intra_chunk_bwd`)
takes the gradients of all three outputs (any may be None) and returns
those of x, dt, A, B and C; :class:`SsdIntraChunkFn` wires forward and
backward for autograd.  Its plan (:func:`ssd_bwd_plan`) sends bf16 with
P >= 8 to the tensor cores (three launches; x, B and C read in place as
token rows, dy in place) and float32 to the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _cuda
from .._device import refuse_dtensor

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_plain", "chunk_cumsum", "ssd_plan", "SsdPlan",
           "ssd_intra_chunk_bwd", "ssd_intra_chunk_bwd_plain", "SsdIntraChunkFn",
           "ssd_bwd_path", "ssd_bwd_plan", "SsdBwdPlan", "ssd_bwd_smem_bytes"]

_F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C, _MAX_P, _MAX_N = 256, 128, 256
#: shared memory one block may take on an H100 (sm_90)
SMEM_MAX = 227 * 1024

_SIG = {
    "ssd_intra_chunk": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]),
}
_BWD_SIG = {
    "ssd_intra_chunk_bwd": (ctypes.c_int, [ctypes.c_void_p] * 14 + [ctypes.c_longlong]
                            + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]),
    "ssd_intra_chunk_bwd_scratch": (ctypes.c_longlong, [ctypes.c_longlong] + [ctypes.c_int] * 7),
    "ssd_intra_chunk_bwd_smem": (ctypes.c_longlong, [ctypes.c_int] * 4),
}
#: the backward's designs by the C entry point's ``path``
_BWD_DESIGNS = {"fma": 0, "mma": 1}
#: main blocks of the tensor-core backward a wave holds at one block an SM
#: (an H100's 132 SMs; doubled where two blocks fit an SM): the head groups
#: follow from it and the shape alone
SSD_BWD_TARGET_BLOCKS = 132
#: s-tiles of 16 rows in one band of the main kernel: one per warp
_BAND_TILES = 8


def chunk_cumsum(dt, A):
    """``cumsum(dt * A)`` over each chunk (dim 2 of ``(B, nb, C, H)``),
    summed in float64 and rounded once to float32, as the kernel forms it
    (kept float64 for float64 inputs)."""
    wide = torch.promote_types(dt.dtype, torch.float32)
    return torch.cumsum(dt.double() * A.double(), dim=2).to(wide)


def ssd_intra_chunk_plain(x, dt, A, Bm, Cm):
    """The plain version: x (B, nb, C, H, P), dt (B, nb, C, H), A (H,),
    Bm/Cm (B, nb, C, N).  Returns (y_intra (B, nb, C, H, P), contrib
    (B, nb, H, P, N), chunk_decay (B, nb, H)), float32.  The exp of a
    masked (s > t) entry is never taken: its exponent is set to -inf."""
    c = x.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    dt = dt.to(acc)
    ack = chunk_cumsum(dt, A)                                         # (B,nb,C,H)
    seg = ack[:, :, :, None, :] - ack[:, :, None, :, :]               # (B,nb,t,s,H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    seg = seg.masked_fill(~causal[None, None, :, :, None], -float("inf"))
    cb = torch.einsum("bktn,bksn->bkts", Cm.to(acc), Bm.to(acc))      # shared by heads
    w = cb[..., None] * torch.exp(seg) * dt[:, :, None, :, :]
    y = torch.einsum("bktsh,bkshp->bkthp", w, x.to(acc))
    coef = dt * torch.exp(ack[:, :, -1:, :] - ack)                    # (B,nb,C,H)
    contrib = torch.einsum("bksh,bksn,bkshp->bkhpn", coef, Bm.to(acc), x.to(acc))
    return y, contrib, torch.exp(ack[:, :, -1, :])


def ssd_intra_chunk_bwd_plain(x, dt, A, Bm, Cm, dy=None, dcontrib=None, ddecay=None):
    """The backward's plain version, written out (a None gradient is zero):
    with ``W[t,s] = CB[t,s] exp(acum_t - acum_s) dt_s`` (s <= t), ``dW = dy
    x^T`` and ``q = dW CB exp(seg)`` per head,

        dx     = W^T dy + coef G,          G = B dcontrib^T,  dcoef = sum_p x G
        dCB    = sum_h dW exp(seg) dt_s,   dC = dCB B,  dB = dCB^T C + sum_h coef x dcontrib
        dacum  = rowsum(q dt_s) - colsum(q dt_s) - dcoef coef
                 (+ sum_s dcoef coef + ddecay decay at the last step)
        ddt    = colsum(q) + dcoef exp(acum_last - acum) + A revcumsum(dacum)
        dA     = sum revcumsum(dacum) dt

    Returns ``(dx, ddt, dA, dB, dC)``: dx / dB / dC in x's dtype, ddt and dA
    in float32 (float64 for float64 inputs)."""
    c = x.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Af, Bf, Cf = x.to(acc), dt.to(acc), A.to(acc), Bm.to(acc), Cm.to(acc)
    ack = chunk_cumsum(dtf, Af)                                       # (B,nb,C,H)
    seg = ack[:, :, :, None, :] - ack[:, :, None, :, :]               # (B,nb,t,s,H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    lw = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], -float("inf")))
    cb = torch.einsum("bktn,bksn->bkts", Cf, Bf)
    last = ack[:, :, -1:, :]
    e_last = torch.exp(last - ack)
    coef = dtf * e_last
    dx = torch.zeros_like(xf)
    d_ack = torch.zeros_like(ack)
    ddt = torch.zeros_like(ack)
    dcb = torch.zeros_like(cb)
    dB = torch.zeros_like(Bf)
    if dy is not None:
        dyf = dy.to(acc)
        w = cb[..., None] * lw * dtf[:, :, None, :, :]
        dx = dx + torch.einsum("bktsh,bkthp->bkshp", w, dyf)
        dw = torch.einsum("bkthp,bkshp->bktsh", dyf, xf)
        q = dw * cb[..., None] * lw
        qd = q * dtf[:, :, None, :, :]
        d_ack = d_ack + qd.sum(dim=3) - qd.sum(dim=2)
        ddt = ddt + q.sum(dim=2)
        dcb = (dw * lw * dtf[:, :, None, :, :]).sum(dim=-1)
        dB = dB + torch.einsum("bkts,bktn->bksn", dcb, Cf)
    if dcontrib is not None:
        dcf = dcontrib.to(acc)
        g = torch.einsum("bksn,bkhpn->bkshp", Bf, dcf)
        dx = dx + coef[..., None] * g
        dcoef = (xf * g).sum(dim=-1)                                  # (B,nb,C,H)
        dB = dB + torch.einsum("bksh,bkshp,bkhpn->bksn", coef, xf, dcf)
        d_ack = d_ack - dcoef * coef
        d_ack[:, :, -1] += (dcoef * coef).sum(dim=2)
        ddt = ddt + dcoef * e_last
    if ddecay is not None:
        d_ack[:, :, -1] += ddecay.to(acc) * torch.exp(last[:, :, 0])
    dC = torch.einsum("bkts,bksn->bktn", dcb, Bf)
    dz = torch.flip(torch.cumsum(torch.flip(d_ack, (2,)), dim=2), (2,))
    ddt = ddt + dz * Af
    dA = (dz * dtf).sum(dim=(0, 1, 2))
    return dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype)


class SsdPlan(NamedTuple):
    """The kernel's block design for one call: ``path`` "mma" (bf16 on the
    tensor cores, one launch of ``smem`` bytes of shared memory per block)
    or "fma" (the CUDA cores, two launches and a (B, nb, C, C) scratch)."""
    path: str
    smem: int


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def mma_smem_bytes(C: int, P: int, N: int) -> int:
    """Shared memory of one tensor-core block (``mma_smem_bytes`` in the
    source, whose launcher refuses any other count): B rows of ``_r16(N) + 8`` bf16, the head's x rows of
    ``max(P, 16) + 8`` bf16, and acum, dt and coef in float32, over
    ``_r16(C)`` rows."""
    cp = _r16(C)
    return 2 * cp * (_r16(N) + 8 + max(P, 16) + 8) + 4 * 3 * cp


@functools.lru_cache(maxsize=1024)
def ssd_plan(dtype, C: int, P: int, N: int) -> SsdPlan:
    """bf16 with P >= 8 goes to the tensor cores when the chunk's B and x
    fit one block's shared memory (``SMEM_MAX``: every shape the kernel
    takes does, C = 256 with P = 128 and N = 256 in 203 KB); float32 and
    P < 8 to the CUDA cores.  The launcher refuses a tensor-core plan whose
    ``smem`` is not its own reckoning or does not fit."""
    if dtype == torch.bfloat16 and P >= 8:
        smem = mma_smem_bytes(C, P, N)
        if smem <= SMEM_MAX:
            return SsdPlan("mma", smem)
    return SsdPlan("fma", 0)


def _max_band_pairs(nt: int) -> int:
    """The most (s, t >= s) tile pairs of one band of the backward's main
    kernel: bands of 8 s-tiles dealt 0, nt - 1, 1, nt - 2, ...
    (``max_band_pairs`` in the source)."""
    order = [nt - 1 - (k >> 1) if k & 1 else k >> 1 for k in range(nt)]
    return max(sum(nt - j for j in order[b:b + _BAND_TILES])
               for b in range(0, nt, _BAND_TILES))


def ssd_bwd_smem_bytes(C: int, P: int, N: int, contrib: bool = False) -> int:
    """Shared memory of one main block of the tensor-core backward
    (``mma_smem_bytes`` in the source, whose launcher refuses any other
    count): the largest band's C.B^T tiles (1 KB each), then the larger of
    the per-head region (dy's rows in bf16 at pitch ``max(P, 16) + 8``, or
    the warps' hand-over of dx where larger, the group's dCB^T tiles, the
    per-segment sums over s, acum, dt and coef; with ``contrib``, the head's
    dcontrib in bf16) and the prologue's staging of C's rows
    and, where both fit, B's (pitch ``_r16(N) + 8``), over ``_r16(C)``
    rows."""
    cp = _r16(C)
    cbt = 4 * 256 * _max_band_pairs(cp // 16)
    dy = max(2 * cp * (max(P, 16) + 8), 4 * 4 * (P // 8 * 128 + 64))
    head = dy + cbt + 4 * (16 + 3) * cp
    both = 2 * 2 * cp * (_r16(N) + 8)
    stage = both if cbt + max(head, both) <= SMEM_MAX else both // 2
    if contrib:
        head += 2 * P * (_r16(N) + 8)
    return cbt + max(head, stage)


def ssd_bwd_path(dtype, C: int, P: int, N: int, contrib: bool = False) -> str:
    """The backward's design for one call, from dtype, shape and whether
    contrib's gradient is given alone: "mma" (bf16 on the tensor cores: P a
    power of two in [8, 128], C and N <= 256, the main block within
    ``SMEM_MAX``, which every such shape is; not P = 128 with ``contrib``,
    whose G product and dx's 64 accumulators a thread would not fit the
    registers, and which no arch of the zoo has) or "fma" (the CUDA cores:
    float32, P < 8)."""
    ok = (dtype == torch.bfloat16 and 8 <= P <= _MAX_P and not P & (P - 1)
          and not (contrib and P == _MAX_P) and 0 < C <= _MAX_C and 0 < N <= _MAX_N
          and ssd_bwd_smem_bytes(C, P, N, contrib) <= SMEM_MAX)
    return "mma" if ok else "fma"


class SsdBwdPlan(NamedTuple):
    """The backward's design for one call: ``path`` "mma" (three launches,
    the main kernel on ``groups`` head groups x ``bands`` bands x chunks,
    ``smem`` bytes a block) or "fma" (the CUDA cores' eight launches)."""
    path: str
    groups: int
    bands: int
    smem: int


@functools.lru_cache(maxsize=1024)
def ssd_bwd_plan(dtype, BC: int, C: int, H: int, P: int, N: int, design=None,
                 contrib: bool = False) -> SsdBwdPlan:
    """The plan :func:`ssd_bwd_path` picks, or ``design`` ("mma" / "fma",
    refused where it cannot run); ``contrib``: whether contrib's gradient is
    given (its head's rows take shared memory, and its product keeps the
    main kernel at one block an SM).  The head groups are the most
    that keep the main kernel within one wave of ``SSD_BWD_TARGET_BLOCKS``
    blocks an SM-slot, so each block's C.B^T is formed once for as many heads
    as the wave allows; depends on the shape alone."""
    path = design or ssd_bwd_path(dtype, C, P, N, contrib)
    if path not in _BWD_DESIGNS:
        raise ValueError(f"unknown ssd_intra_chunk_bwd design {path!r}")
    if path == "mma" and ssd_bwd_path(dtype, C, P, N, contrib) != "mma":
        raise ValueError(f"the mma design takes bf16 with P a power of two in [8, {_MAX_P}] "
                         f"(below {_MAX_P} with contrib's gradient) and C <= {_MAX_C}, got "
                         f"{dtype} C={C} P={P}")
    if path == "fma":
        return SsdBwdPlan("fma", 1, 1, 0)
    nt = _r16(C) // 16
    bands = -(-nt // _BAND_TILES)
    smem = ssd_bwd_smem_bytes(C, P, N, contrib)
    # two blocks an SM where two fit and dcontrib's product is not in the kernel
    per_sm = 2 if P <= 64 and not contrib and 2 * (smem + 1024) <= 228 * 1024 else 1
    groups = max(1, min(H, SSD_BWD_TARGET_BLOCKS * per_sm // (BC * bands)))
    return SsdBwdPlan("mma", groups, bands, smem)


def _row_stride(t, inner):
    """The row stride of ``t`` (B, nb, C, ...) seen as B * nb * C token rows
    of ``inner`` contiguous elements, or None if it is not laid out so."""
    sh, st = t.shape, t.stride()
    want = 1
    for d in range(t.dim() - 1, 2, -1):
        if sh[d] != 1 and st[d] != want:
            return None
        want *= sh[d]
    rs = st[2]
    if rs < inner or (sh[1] != 1 and st[1] != rs * sh[2]) or \
            (sh[0] != 1 and st[0] != rs * sh[2] * sh[1]):
        return None
    return rs


def _fresh(t):
    """A contiguous copy of ``t`` in new (aligned) storage."""
    return t.clone(memory_format=torch.contiguous_format)


_FN = []


def _fn():
    """The kernel's entry point, built and loaded at first use."""
    if not _FN:
        _FN.append(_cuda.load("ssd_intra_chunk", _SIG).ssd_intra_chunk)
    return _FN[0]


def _ssd_intra_chunk_cuda(x, dt, A, Bm, Cm):
    """Launch ``csrc/ssd_intra_chunk.cu`` on the current stream."""
    dtype = x.dtype
    code = _DTYPES.get(dtype)
    if code is None or Bm.dtype is not dtype or Cm.dtype is not dtype:
        raise TypeError(f"ssd_intra_chunk takes float32 or bfloat16 x/Bm/Cm of one dtype, "
                        f"got {dtype} / {Bm.dtype} / {Cm.dtype}")
    if dt.dtype is not _F32 or A.dtype is not _F32:
        raise TypeError(f"ssd_intra_chunk takes float32 dt and A, got {dt.dtype} / {A.dtype}")
    if x.dim() != 5:
        raise ValueError(f"want x (B, nb, C, H, P), got {tuple(x.shape)}")
    b, nb, c, h, p = x.shape
    n = Bm.shape[-1]
    if (dt.shape != (b, nb, c, h) or A.shape != (h,)
            or Bm.shape != (b, nb, c, n) or Cm.shape != (b, nb, c, n)):
        raise ValueError(f"ssd_intra_chunk shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)}")
    dev = x.get_device()
    if not (dt.get_device() == A.get_device() == Bm.get_device() == Cm.get_device() == dev):
        raise ValueError("ssd_intra_chunk: inputs lie on different devices")
    if (not 0 < c <= _MAX_C or not 0 < p <= _MAX_P or p & (p - 1)
            or not 0 < n <= _MAX_N or b * nb == 0 or h == 0):
        raise ValueError(f"ssd_intra_chunk takes 0 < C <= {_MAX_C}, P a power of two "
                         f"<= {_MAX_P}, 0 < N <= {_MAX_N}, got x {tuple(x.shape)}, N={n}")
    plan = ssd_plan(dtype, c, p, n)
    mma = plan.path == "mma"
    if not dt.is_contiguous():
        dt = dt.contiguous()
    if not A.is_contiguous():
        A = A.contiguous()
    # token rows read in place (the model hands slices of one projection);
    # the tensor-core path needs x's rows 16-byte aligned, the CUDA cores
    # contiguous operands
    x_rs = _row_stride(x, h * p)
    if mma:
        x_ok = x_rs is not None and x_rs % 8 == 0 and x.data_ptr() % 16 == 0
    else:
        x_ok = x_rs == h * p
    if not x_ok:
        x, x_rs = _fresh(x), h * p
    b_rs = _row_stride(Bm, n)
    if b_rs is None or (not mma and b_rs != n):
        Bm, b_rs = _fresh(Bm), n
    c_rs = _row_stride(Cm, n)
    if c_rs is None or (not mma and c_rs != n):
        Cm, c_rs = _fresh(Cm), n
    f32 = dict(dtype=_F32, device=x.device)
    y = torch.empty((b, nb, c, h, p), **f32)
    contrib = torch.empty((b, nb, h, p, n), **f32)
    decay = torch.empty((b, nb, h), **f32)
    cb = None if mma else torch.empty((b, nb, c, c), **f32)   # scratch: C.B^T per chunk
    err = _fn()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if mma else cb.data_ptr(), y.data_ptr(), contrib.data_ptr(), decay.data_ptr(),
        b * nb, c, h, p, n, x_rs, b_rs, c_rs, code, 1 if mma else 0, plan.smem,
        torch._C._cuda_getCurrentRawStream(dev),
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
    refuse_dtensor("ssd_intra_chunk", x, dt, A, Bm, Cm)
    if x.device.type == "cuda":
        return _ssd_intra_chunk_cuda(x, dt, A, Bm, Cm)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_intra_chunk: unsupported device {x.device}")
    return ssd_intra_chunk_plain(x, dt, A, Bm, Cm)


ssd_intra_chunk.launches = 0


def _bwd_checked(x, dt, A, Bm, Cm, dy=None, dcontrib=None, ddecay=None, design=None):
    """The backward kernel's operand rules, checked before anything is
    built or launched; returns ``(B, nb, C, H, P, N, plan)``."""
    dtype = x.dtype
    code = _DTYPES.get(dtype)
    if code is None or Bm.dtype is not dtype or Cm.dtype is not dtype:
        raise TypeError(f"ssd_intra_chunk_bwd takes float32 or bfloat16 x/Bm/Cm of one "
                        f"dtype, got {dtype} / {Bm.dtype} / {Cm.dtype}")
    if dt.dtype is not _F32 or A.dtype is not _F32:
        raise TypeError(f"ssd_intra_chunk_bwd takes float32 dt and A, got {dt.dtype} / "
                        f"{A.dtype}")
    if x.dim() != 5:
        raise ValueError(f"want x (B, nb, C, H, P), got {tuple(x.shape)}")
    b, nb, c, h, p = x.shape
    n = Bm.shape[-1]
    want = {"dt": (dt, (b, nb, c, h)), "A": (A, (h,)), "Bm": (Bm, (b, nb, c, n)),
            "Cm": (Cm, (b, nb, c, n)), "dy": (dy, (b, nb, c, h, p)),
            "dcontrib": (dcontrib, (b, nb, h, p, n)), "ddecay": (ddecay, (b, nb, h))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"ssd_intra_chunk_bwd: {name} {tuple(t.shape)}, want {shape} "
                             f"for x {tuple(x.shape)}")
        if t is not None and t.device != x.device:
            raise ValueError("ssd_intra_chunk_bwd: inputs lie on different devices")
    if b * nb * c * h * p * n == 0:
        raise ValueError(f"empty ssd_intra_chunk_bwd: x {tuple(x.shape)}, N={n}")
    return b, nb, c, h, p, n, ssd_bwd_plan(dtype, b * nb, c, h, p, n, design,
                                           dcontrib is not None)


def _ssd_intra_chunk_bwd_cuda(x, dt, A, Bm, Cm, dy=None, dcontrib=None, ddecay=None,
                              design=None):
    """Launch ``csrc/ssd_intra_chunk_bwd.cu`` on the current stream, on the
    design :func:`ssd_bwd_plan` picks, or ``design``: "mma" its three
    tensor-core kernels (main, dB / dC and the finish, dA), "fma" the
    CUDA cores' eight."""
    b, nb, c, h, p, n, plan = _bwd_checked(x, dt, A, Bm, Cm, dy, dcontrib, ddecay, design)
    mma = plan.path == "mma"
    dt, A = dt.contiguous(), A.contiguous()
    if mma:
        # token rows read in place: x's pairs 4-byte aligned, B and C any stride
        x_rs = _row_stride(x, h * p)
        if x_rs is None or x_rs % 2 or x.data_ptr() % 4:
            x, x_rs = _fresh(x), h * p
        b_rs = _row_stride(Bm, n)
        if b_rs is None:
            Bm, b_rs = _fresh(Bm), n
        c_rs = _row_stride(Cm, n)
        if c_rs is None:
            Cm, c_rs = _fresh(Cm), n
    else:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
        x_rs, b_rs, c_rs = h * p, n, n
    # dy arrives as float32 from y_intra's grad: read in place, 16-byte aligned
    if dy is not None:
        dy = dy.float().contiguous()
        if dy.data_ptr() % 16:
            dy = _fresh(dy)
    dcontrib, ddecay = (None if t is None else t.float().contiguous()
                        for t in (dcontrib, ddecay))
    if dcontrib is not None and dcontrib.data_ptr() % 16:
        dcontrib = _fresh(dcontrib)
    lib = _cuda.load("ssd_intra_chunk_bwd", _BWD_SIG)
    bc = b * nb
    f32 = dict(dtype=_F32, device=x.device)
    scratch = torch.empty((lib.ssd_intra_chunk_bwd_scratch(
        bc, c, h, p, n, _BWD_DESIGNS[plan.path], plan.groups, dcontrib is not None),), **f32)
    dx = torch.empty((b, nb, c, h, p), dtype=x.dtype, device=x.device)
    dB, dC = torch.empty((2, b, nb, c, n), dtype=Bm.dtype, device=x.device)
    ddt = torch.empty((b, nb, c, h), **f32)
    dA = torch.empty((h,), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ssd_intra_chunk_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), ptr(dy),
        ptr(dcontrib), ptr(ddecay), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(), bc, c, h, p, n, _DTYPES[x.dtype],
        _BWD_DESIGNS[plan.path], plan.groups, plan.smem, x_rs, b_rs, c_rs,
        torch._C._cuda_getCurrentRawStream(x.get_device()),
    )
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_bwd launch failed: CUDA error {err}")
    ssd_intra_chunk_bwd.launches += 1
    return dx, ddt, dA, dB, dC


def ssd_intra_chunk_bwd(x, dt, A, Bm, Cm, dy=None, dcontrib=None, ddecay=None):
    """The intra-chunk part's backward on whatever device ``x`` lies on: the
    CUDA kernel for a CUDA tensor (raising if it cannot build or launch),
    the plain version for a CPU tensor.  ``dy``, ``dcontrib`` and ``ddecay``
    are the gradients of y_intra, contrib and chunk_decay (None: zero).
    Returns ``(dx, ddt, dA, dB, dC)``.  ``ssd_intra_chunk_bwd.launches``
    counts kernel launches."""
    refuse_dtensor("ssd_intra_chunk_bwd", x, dt, A, Bm, Cm, dy, dcontrib, ddecay)
    if x.device.type == "cuda":
        return _ssd_intra_chunk_bwd_cuda(x, dt, A, Bm, Cm, dy, dcontrib, ddecay)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_intra_chunk_bwd: unsupported device {x.device}")
    return ssd_intra_chunk_bwd_plain(x, dt, A, Bm, Cm, dy, dcontrib, ddecay)


ssd_intra_chunk_bwd.launches = 0


class SsdIntraChunkFn(torch.autograd.Function):
    """Differentiable intra-chunk SSD part: the forward is
    :func:`ssd_intra_chunk`, the backward :func:`ssd_intra_chunk_bwd`
    (kernels for CUDA tensors, plain versions for CPU tensors).  Only the
    five inputs are kept between the two; an output whose gradient autograd
    does not supply costs the backward nothing.

        y_intra, contrib, chunk_decay = SsdIntraChunkFn.apply(x, dt, A, Bm, Cm)
    """

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        return ssd_intra_chunk(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dcontrib, ddecay):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssd_intra_chunk_bwd(x, dt, A, Bm, Cm, dy, dcontrib, ddecay)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC
