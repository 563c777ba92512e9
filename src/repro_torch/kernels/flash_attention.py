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

:func:`flash_plan` picks the kernel's block design and its split-KV
plan (flash-decoding) from the shapes and the card's SM count: when the
blocks over (query rows, batch, KV head) cannot fill the card, the keys
are cut into ranges, one block per range writes a float32 partial
``(o, m, l)`` to scratch allocated here, and a second kernel merges the
ranges in order.  :func:`flash_partial_plain` and
:func:`flash_merge_plain` are that algebra in plain torch.

With ``return_lse`` the forward also returns each row's log-sum-exp
``m + log(max(l, 1e-30))`` (B, Hq, Lq) float32, on every plan (a split
plan's from the merge).  :class:`FlashAttentionFn` is attention's
gradient: its forward saves q, k, v, out and lse, and its backward,
:func:`flash_attention_bwd`, launches ``csrc/flash_attention_bwd.cu``
for tensors on the card and runs :func:`flash_attention_bwd_plain` (the
reference's ``_flash_bwd``, step for step) for tensors on the CPU.
:func:`flash_bwd_plan` picks the backward's design (bf16 at D up to 256
on the tensor cores) and cuts each KV head's query heads into head groups
from the shape alone; :func:`flash_attention_bwd_grouped_plain` is the
groups' algebra in plain torch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import _cuda
from .._device import refuse_dtensor
from ..models.common import _IMAX, NEG_INF, _apply_softcap, _mask_for, chunked_attention

__all__ = ["FlashAttentionFn", "FlashBwdPlan", "FlashPlan", "bwd_path", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_grouped_plain",
           "flash_attention_bwd_plain", "flash_attention_plain", "flash_bwd_plan",
           "flash_merge_plain", "flash_partial_plain", "flash_plan", "split_ranges"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256

_SIG = {
    "flash_attention": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]),
}
_BWD_SIG = {
    "flash_attention_bwd": (ctypes.c_int, [
        *[ctypes.c_void_p] * 10,
        *[ctypes.c_int] * 11,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]),
}
#: the backward's designs by the C entry point's ``path``: "mma" the
#: tensor cores (bf16, D <= 256), "fma" the CUDA cores
_BWD_DESIGNS = {"fma": 0, "mma": 1}
#: keys per dK/dV block and query rows per dQ block of each design
#: (``kRingKeys``, ``kRingRows``; ``kBK``, ``kBQ``)
_BWD_TILES = {"mma": (64, 64), "fma": (32, 32)}
#: dK/dV blocks the head-group split aims for (a fixed number, not the
#: card's SM count, so the sums are the same on every card)
BWD_TARGET_BLOCKS = 128
#: most key ranges one call splits into (the merge kernel's limit)
MAX_SPLITS = 256


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the kernel covers one call: ``path`` "mma" (bf16 on the tensor
    cores) or "fma" (CUDA cores: float32, or a bf16 width that is not a
    multiple of 8); ``block_rows`` query rows and tiles of ``block_keys``
    keys per block, ``row_tiles`` blocks over a KV head's rows; ``splits``
    key ranges of ``keys_per_split`` keys from ``key_base``."""

    path: str
    block_rows: int
    block_keys: int
    row_tiles: int
    key_base: int
    keys_per_split: int
    splits: int

    def blocks(self, B: int, Hkv: int) -> int:
        return self.row_tiles * B * Hkv * self.splits


def flash_plan(dtype, B, Hq, Hkv, Lq, Lk, D, *, n_sm, causal=True, window=0,
               q_offset=0, kv_offset=0, kv_valid_len=None, ring=False,
               aligned=True) -> FlashPlan:
    """The kernel's block design and split-KV plan for one call.

    The keys any query can see, ``[key_base, end)`` (the whole ring with
    ``ring``), are cut into ranges of whole tiles only when the blocks over
    (row tiles, B, Hkv) number fewer than ``n_sm``: then into as many
    ranges as fill the SMs, at most one per tile and ``MAX_SPLITS``.
    The kernel takes ``block_rows`` and ``block_keys`` from the plan; its
    launcher refuses keys per tile other than the instantiated tile
    (``MmaTile::kBN``, ``kFmaBK``) and rows other than 16..64 in steps of
    16 (tensor cores) or 32 (CUDA cores)."""
    return _plan(dtype, B, Hq, Hkv, Lq, Lk, D, n_sm, causal, window, q_offset, kv_offset,
                 kv_valid_len, ring, aligned)


@functools.lru_cache(maxsize=4096)
def _plan(dtype, B, Hq, Hkv, Lq, Lk, D, n_sm, causal, window, q_offset, kv_offset,
          kv_valid_len, ring, aligned) -> FlashPlan:
    """``flash_plan``, cached on positional arguments (the wrapper's
    per-call path)."""
    rows = (Hq // Hkv) * Lq
    if dtype == torch.bfloat16 and D % 8 == 0 and aligned:
        path, block_rows = "mma", 16 * min(4, -(-rows // 16))
        bk = 32 if D > 128 else 64
    else:
        path, block_rows, bk = "fma", 32, 32
    lo, hi = 0, Lk
    if not ring:
        hi = min(Lk, Lk if kv_valid_len is None else int(kv_valid_len))
        if causal:
            hi = min(hi, q_offset + Lq - kv_offset)
        if window > 0:
            lo = max(0, q_offset - window + 1 - kv_offset) // bk * bk
    tiles = max(1, -(-(hi - lo) // bk))
    row_tiles = -(-rows // block_rows)
    blocks = row_tiles * B * Hkv
    splits, per = 1, tiles
    if blocks < n_sm and tiles > 1:
        want = min(tiles, -(-n_sm // blocks), MAX_SPLITS)
        per = -(-tiles // want)
        splits = -(-tiles // per)
    return FlashPlan(path, block_rows, bk, row_tiles, lo, per * bk, splits)


def split_ranges(plan: FlashPlan) -> List[Tuple[int, int]]:
    """The key range ``[lo, hi)`` of each split of ``plan``."""
    return [(plan.key_base + s * plan.keys_per_split,
             plan.key_base + (s + 1) * plan.keys_per_split) for s in range(plan.splits)]


_N_SM: Dict[int, int] = {}


def _sm_count(idx: int) -> int:
    """SMs of CUDA device ``idx``."""
    n = _N_SM.get(idx)
    if n is None:
        n = _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                          scale: Optional[float] = None, q_offset=0,
                          kv_offset=0, kv_valid_len=None, kv_positions=None,
                          return_lse=False):
    """The plain version: blockwise online softmax in torch."""
    return chunked_attention(
        q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
        q_offset=q_offset, kv_offset=kv_offset, kv_valid_len=kv_valid_len,
        kv_positions=kv_positions, return_lse=return_lse,
    )


def flash_partial_plain(q, k, v, key_lo, key_hi, *, causal=True, window=0,
                        softcap=0.0, scale: Optional[float] = None, q_offset=0,
                        kv_offset=0, kv_valid_len=None, kv_positions=None):
    """One split's partial, as the kernel forms it: attention of ``q``
    over the keys ``[key_lo, key_hi)`` only.  Returns float32 ``(o, m,
    l)``: ``o`` (B, Hq, Lq, D) the unnormalised sum of ``p v`` (p rounded
    to v's dtype), ``m`` and ``l`` (B, Hq, Lq) the row maximum and the
    sum of ``p``; a row with no valid key in the range has ``m = -1e30``,
    ``l = 0`` and ``o = 0``."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    g = hq // hkv
    sc = scale if scale is not None else d ** -0.5
    lo, hi = max(0, int(key_lo)), max(0, min(lk, int(key_hi)))
    hi = max(lo, hi)
    dev = q.device
    qpos = q_offset + torch.arange(lq, dtype=torch.int64, device=dev)
    idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    if kv_positions is not None:
        kpos = kv_positions[lo:hi].to(device=dev, dtype=torch.int64)
        ok = kpos >= 0
    else:
        kpos = kv_offset + idx
        ok = idx < (lk if kv_valid_len is None else int(kv_valid_len))
    mask = ok[None, :].expand(lq, -1)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    qg = q.reshape(b, hkv, g, lq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k[:, :, lo:hi].float()) * sc
    s = _apply_softcap(s, softcap)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF, device=dev)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v[:, :, lo:hi].float())
    none = ~mask.any(dim=-1)                       # (Lq,)
    m = torch.where(none, torch.full_like(m, NEG_INF), m)
    l = torch.where(none, torch.zeros_like(l), l)
    o = torch.where(none[:, None], torch.zeros_like(o), o)
    return o.reshape(b, hq, lq, d), m.reshape(b, hq, lq), l.reshape(b, hq, lq)


def flash_merge_plain(o, m, l, dtype, return_lse=False):
    """Merge split partials stacked on dim 0 (``o`` (S, ..., D), ``m``
    and ``l`` (S, ...)) in split order; a row with no valid key in any
    split is 0.  ``return_lse`` also returns the merged rows' log-sum-exp
    ``M + log(max(L, 1e-30))``, as the merge kernel writes it."""
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    L = (w * l).sum(dim=0)
    O = (w[..., None] * o).sum(dim=0)
    out = O / torch.clamp(L, min=1e-30)[..., None]
    out = torch.where((M <= 0.5 * NEG_INF)[..., None], torch.zeros_like(out), out)
    if return_lse:
        return out.to(dtype), M + torch.log(torch.clamp(L, min=1e-30))
    return out.to(dtype)


def _flash_attention_cuda(q, k, v, *, causal, window, softcap, scale,
                          q_offset, kv_offset, kv_valid_len, kv_positions=None,
                          return_lse=False):
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
    aligned = (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    dev = q.get_device()
    plan = _plan(q.dtype, B, Hq, Hkv, Lq, Lk, D, _sm_count(dev), causal, int(window),
                 int(q_offset), int(kv_offset), valid, kvp is not None, aligned)
    lib = _cuda.load("flash_attention", _SIG)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device) if return_lse else None
    part = [None, None, None]
    if plan.splits > 1:
        n = plan.splits * B * Hkv * (Hq // Hkv) * Lq     # partial rows
        buf = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        ptr = buf.data_ptr()
        part = [ptr, ptr + 4 * n * D, ptr + 4 * n * (D + 1)]
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kvp is None else kvp.data_ptr(), out.data_ptr(), *part,
        B, Hq, Hkv, Lq, Lk, D,
        int(q_offset), int(kv_offset), valid,
        int(bool(causal)), int(window), float(softcap), float(sc),
        _DTYPES[q.dtype], int(plan.path == "mma"), plan.block_rows, plan.block_keys,
        plan.key_base, plan.keys_per_split, plan.splits,
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale: Optional[float] = None, q_offset=0, kv_offset=0,
                    kv_valid_len=None, kv_positions=None, return_lse=False):
    """Attention on whatever device ``q`` lies on: the CUDA kernel for a
    CUDA tensor (raising if it cannot build or launch), the plain
    version for a CPU tensor.  ``return_lse`` also returns the rows'
    log-sum-exp.  ``flash_attention.launches`` counts kernel launches."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, kv_offset=kv_offset, kv_valid_len=kv_valid_len,
              kv_positions=kv_positions, return_lse=return_lse)
    refuse_dtensor("flash_attention", q, k, v, kv_positions)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_plain(q, k, v, **kw)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True, window=0,
                              softcap=0.0, scale: Optional[float] = None, q_offset=0,
                              kv_offset=0, kv_valid_len=None, block: int = 1024):
    """dq, dk, dv of :func:`chunked_attention` (no ``kv_positions``), step
    for step as the reference's ``_flash_bwd``: ``delta = sum(dout *
    out)``, each key block's probabilities recomputed from ``lse``, the
    softcap's derivative ``1 - tanh^2``, float32 throughout, each
    gradient in its input's dtype.  ``out`` (B, Hq, Lq, D) and ``lse``
    (B, Hq, Lq) are the forward's."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    g = hq // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    window = int(window)
    block = min(block, lk)
    nb = -(-lk // block)
    pad = nb * block - lk
    kf, vf = k.float(), v.float()
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    qpos = q_offset + torch.arange(lq, dtype=torch.int64, device=dev)
    valid = lk if kv_valid_len is None else int(kv_valid_len)
    idx = torch.arange(nb * block, dtype=torch.int64, device=dev)
    kvpos = torch.where(idx < min(valid, lk), kv_offset + idx, torch.full_like(idx, _IMAX))

    qg = q.reshape(b, hkv, g, lq, d).float()
    do = dout.reshape(b, hkv, g, lq, d).float()
    delta = torch.sum(do * out.reshape(b, hkv, g, lq, d).float(), dim=-1)
    lse = lse.reshape(b, hkv, g, lq)
    dq = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=dev)
    dk = torch.empty((b, hkv, nb * block, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    for bi in range(nb):
        sl = slice(bi * block, (bi + 1) * block)
        kblk, vblk = kf[:, :, sl], vf[:, :, sl]
        raw = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk) * sc
        if softcap > 0:
            t = torch.tanh(raw / softcap)
            s = softcap * t
            dcap = 1.0 - t * t
        else:
            s, dcap = raw, None
        mask = _mask_for(causal, qpos, kvpos[sl], window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[..., None])
        dv[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vblk)
        ds = p * (dp - delta[..., None])
        if dcap is not None:
            ds = ds * dcap
        ds = ds * sc
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kblk)
        dk[:, :, sl] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return (dq.reshape(b, hq, lq, d).to(q.dtype), dk[:, :, :lk].to(k.dtype),
            dv[:, :, :lk].to(v.dtype))


def bwd_path(dtype, D: int, aligned: bool = True) -> str:
    """The backward kernel's design for one call: "mma" (bf16 on the
    tensor cores: D a multiple of 8 up to 256, 16-byte aligned operands)
    or "fma" (CUDA cores: float32, other widths)."""
    return "mma" if dtype == torch.bfloat16 and D % 8 == 0 and D <= _MAX_D and aligned else "fma"


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """How the backward covers one call: ``path`` (a key of
    ``_BWD_DESIGNS``); the dK/dV kernel's ``key_tiles`` tiles of
    ``block_keys`` keys per (batch, KV head), each KV head's G query heads
    cut into ``groups`` groups of ``heads_per_group``; the dQ kernel's
    ``row_tiles`` tiles of ``block_rows`` rows per query head."""

    path: str
    block_keys: int
    key_tiles: int
    groups: int
    heads_per_group: int
    block_rows: int
    row_tiles: int

    def dkdv_blocks(self, B: int, Hkv: int) -> int:
        return self.key_tiles * B * Hkv * self.groups

    def dq_blocks(self, B: int, Hq: int) -> int:
        return self.row_tiles * B * Hq

    def scratch_floats(self, B: int, Hkv: int, Lk: int, D: int) -> int:
        """float32 partials of dk and dv the caller allocates (0 for one
        group: the dK/dV kernel then writes dk and dv itself)."""
        return 2 * self.groups * B * Hkv * Lk * D if self.groups > 1 else 0


def flash_bwd_plan(dtype, B, Hq, Hkv, Lq, Lk, D, *, aligned=True, design=None) -> FlashBwdPlan:
    """The backward's design and head-group plan for one call, from the
    shape alone.  ``design`` overrides :func:`bwd_path` (to time another
    design on the same inputs).  On the "mma" design a KV head's G query
    heads are cut into the fewest groups (a divisor of G) whose dK/dV
    blocks reach ``BWD_TARGET_BLOCKS``, else into G groups of one head;
    each group's float32 partials are summed in group order by a third
    kernel.  Other designs take one group."""
    path = design or bwd_path(dtype, D, aligned)
    if path not in _BWD_DESIGNS:
        raise ValueError(f"unknown backward design {path!r}")
    bk, br = _BWD_TILES[path]
    g = Hq // Hkv
    key_tiles = -(-Lk // bk)
    groups = 1
    if path == "mma":
        base = key_tiles * B * Hkv
        groups = next((d for d in range(1, g + 1) if g % d == 0
                       and base * d >= BWD_TARGET_BLOCKS), g)
    return FlashBwdPlan(path, bk, key_tiles, groups, g // groups, br, -(-Lq // br))


def flash_attention_bwd_grouped_plain(q, k, v, out, lse, dout, groups: int, **kw):
    """The head-group algebra of the "mma" design in plain torch: each
    group's heads give float32 partials of dk and dv (their dq is exact),
    summed in group order and rounded once to the inputs' dtype.  Equal to
    :func:`flash_attention_bwd_plain` up to float32 summation order."""
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if groups < 1 or g % groups:
        raise ValueError(f"{groups} groups do not divide {g} query heads per KV head")
    hpg = g // groups

    def heads(t, gi):
        return t.reshape(b, hkv, g, *t.shape[2:])[:, :, gi * hpg:(gi + 1) * hpg].reshape(
            b, hkv * hpg, *t.shape[2:])

    dqs, dk, dv = [], None, None
    for gi in range(groups):
        dq_g, dk_g, dv_g = flash_attention_bwd_plain(
            heads(q, gi).float(), k.float(), v.float(), heads(out, gi).float(), heads(lse, gi),
            heads(dout, gi).float(), **kw)
        dqs.append(dq_g.reshape(b, hkv, hpg, lq, d))
        dk = dk_g if dk is None else dk + dk_g
        dv = dv_g if dv is None else dv + dv_g
    dq = torch.cat(dqs, dim=2).reshape(b, hq, lq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_checked(q, k, v, out, lse, dout, kv_valid_len, design=None):
    """The backward kernel's operand rules, checked before anything is
    built or launched; returns ``(valid, plan)``."""
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, out, dout)):
        raise TypeError(
            f"flash_attention_bwd takes float32 or bfloat16 q/k/v/out/dout of one dtype, "
            f"got {q.dtype} / {k.dtype} / {v.dtype} / {out.dtype} / {dout.dtype}"
        )
    if any(t.device != q.device for t in (k, v, out, lse, dout)):
        raise ValueError("flash_attention_bwd: q, k, v, out, lse and dout on different devices")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"want q (B, Hq, Lq, D) and k, v (B, Hkv, Lk, D), got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if not 0 < D <= _MAX_D or Lq == 0 or Lk == 0 or B == 0:
        raise ValueError(f"flash_attention_bwd takes 0 < D <= {_MAX_D} and non-empty "
                         f"q/k, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"shaped as q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Lq):
        raise ValueError(f"lse must be ({B}, {Hq}, {Lq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    valid = Lk if kv_valid_len is None else min(int(kv_valid_len), Lk)
    if valid < 1:
        raise ValueError(f"kv_valid_len must be >= 1, got {kv_valid_len}")
    aligned = all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v, dout))
    plan = flash_bwd_plan(q.dtype, B, Hq, Hkv, Lq, Lk, D, aligned=aligned, design=design)
    if plan.path == "mma" and bwd_path(q.dtype, D, aligned) != "mma":
        raise ValueError(f"the mma design takes 16-byte aligned bf16 with D a multiple of 8 "
                         f"up to {_MAX_D}, got {q.dtype} D={D}")
    return valid, plan


def _flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal, window, softcap, scale,
                              q_offset, kv_offset, kv_valid_len, design=None):
    """Launch ``csrc/flash_attention_bwd.cu`` on the current stream: the
    delta pass, the dK/dV kernel and the dQ kernel (and the head groups'
    sum), on the design :func:`flash_bwd_plan` picks, or ``design``."""
    q, k, v, out, lse, dout = (t.contiguous() for t in (q, k, v, out, lse, dout))
    valid, plan = _bwd_checked(q, k, v, out, lse, dout, kv_valid_len, design)
    B, Hq, Lq, D = q.shape
    _, Hkv, Lk, _ = k.shape
    sc = scale if scale is not None else D ** -0.5
    dev = q.get_device()
    lib = _cuda.load("flash_attention_bwd", _BWD_SIG)
    delta = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_part = plan.scratch_floats(B, Hkv, Lk, D)
    part = torch.empty(n_part, dtype=torch.float32, device=q.device) if n_part else None
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Hq, Hkv, Lq, Lk, D, int(q_offset), int(kv_offset), valid,
        int(bool(causal)), int(window), float(softcap), float(sc), _DTYPES[q.dtype],
        _BWD_DESIGNS[plan.path], plan.groups, None if part is None else part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0, softcap=0.0,
                        scale: Optional[float] = None, q_offset=0, kv_offset=0,
                        kv_valid_len=None):
    """Attention's backward on whatever device ``q`` lies on: the CUDA
    kernel for a CUDA tensor (raising if it cannot build or launch), the
    plain version for a CPU tensor.  Returns (dq, dk, dv).
    ``flash_attention_bwd.launches`` counts kernel launches."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, kv_offset=kv_offset, kv_valid_len=kv_valid_len)
    refuse_dtensor("flash_attention_bwd", q, k, v, out, lse, dout)
    if q.device.type == "cuda":
        return _flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (no ``kv_positions``): the forward
    is :func:`flash_attention` with the log-sum-exp, the backward
    :func:`flash_attention_bwd`, on the kernel for CUDA tensors and the
    plain versions for CPU tensors.  The reference's ``custom_vjp``
    ``_flash_core``: nothing but q, k, v, out and lse is kept between
    the two.

        out = FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                     scale, q_offset, kv_offset, kv_valid_len)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, softcap=0.0, scale=None,
                q_offset=0, kv_offset=0, kv_valid_len=None):
        kw = dict(causal=causal, window=int(window), softcap=float(softcap), scale=scale,
                  q_offset=int(q_offset), kv_offset=int(kv_offset),
                  kv_valid_len=kv_valid_len)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None
