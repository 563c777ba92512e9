"""Shared NN substrate, forward only: init, norms, RoPE, chunked
(flash-style) attention and the gated MLP.

Functional torch over nested-dict parameter trees, in the reference's
layouts (attention is ``(B, H, L, D)``).  The cross-entropy and the
attention VJP wait for the training slice (ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "NEG_INF",
    "dense_init",
    "rms_norm",
    "rope",
    "chunked_attention",
    "gated_mlp_init",
    "gated_mlp",
]

NEG_INF = -1e30
_IMAX = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               scale: Optional[float] = None, *, device="cpu",
               stack: int = 0) -> torch.Tensor:
    """N(0, 1) * scale (default ``1/sqrt(fan_in)``, fan_in = ``shape[0]``)
    drawn in float32 from ``gen`` and cast to ``dtype``.  ``stack > 0``
    draws ``stack`` independent layers as one ``(stack, *shape)`` tensor.
    On the ``meta`` device only the shape and dtype are made."""
    fan_in = shape[0] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    full = ((stack,) if stack else ()) + tuple(shape)
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(full, dtype=dtype, device=dev)
    x = torch.randn(full, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * s).to(dtype).to(dev)


# ---------------------------------------------------------------------------
# norms & rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., L, D) with D even; positions: (L,)."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(float(theta), dtype=torch.float32, device=x.device))
    freq = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _apply_softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(s / cap)
    return s


def _mask_for(causal: bool, qpos, kpos, window: int) -> torch.Tensor:
    mask = (kpos != _IMAX)[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask  # (Lq, BK)


def chunked_attention(
    q: torch.Tensor,            # (B, Hq, Lq, D)
    k: torch.Tensor,            # (B, Hkv, Lk, D)
    v: torch.Tensor,            # (B, Hkv, Lk, D)
    *,
    causal: bool = True,
    window: int = 0,            # <= 0 means global
    softcap: float = 0.0,
    q_offset: int = 0,          # absolute position of q[..., 0, :]
    kv_offset: int = 0,         # absolute position of k[..., 0, :]
    kv_valid_len: Optional[int] = None,  # #valid kv entries (padded caches)
    kv_positions: Optional[torch.Tensor] = None,  # (Lk,) ring positions; < 0 empty
    block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks: the flash-attention
    algorithm in plain torch, step for step as the reference's forward
    (``m``/``l``/``acc`` in float32, masked logits at ``-1e30``, the
    probabilities cast to ``v``'s dtype before the PV product, output
    ``acc / max(l, 1e-30)`` in ``q``'s dtype).

    GQA (Hq a multiple of Hkv), causal masking, sliding windows, logit
    softcap, padded decode caches and ring-buffer position maps
    (``kv_positions`` replaces ``kv_offset`` and ``kv_valid_len``).  This
    is the plain version of the CUDA flash-attention kernel
    (:mod:`repro_torch.kernels.flash_attention`).
    """
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    g = hq // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    window = int(window)

    block = min(block, lk)
    nb = -(-lk // block)
    pad = nb * block - lk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))

    qpos = q_offset + torch.arange(lq, dtype=torch.int64, device=dev)
    if kv_positions is not None:
        kvpos = kv_positions.to(device=dev, dtype=torch.int64)
        kvpos = torch.where(kvpos < 0, torch.full_like(kvpos, _IMAX), kvpos)
    else:
        valid = lk if kv_valid_len is None else int(kv_valid_len)
        idx = torch.arange(lk, dtype=torch.int64, device=dev)
        kvpos = torch.where(idx < valid, kv_offset + idx, torch.full_like(idx, _IMAX))
    if pad:
        kvpos = F.pad(kvpos, (0, pad), value=_IMAX)

    qg = q.reshape(b, hkv, g, lq, d).float()
    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=dev)
    for bi in range(nb):
        sl = slice(bi * block, (bi + 1) * block)
        kblk, vblk = k[:, :, sl], v[:, :, sl]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kblk.float()) * sc
        s = _apply_softcap(s, softcap)
        mask = _mask_for(causal, qpos, kvpos[sl], window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(vblk.dtype).float(), vblk.float()
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, lq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def gated_mlp_init(gen, d_model: int, d_ff: int, dtype, *, device="cpu", stack: int = 0):
    return {
        "wg": dense_init(gen, (d_model, d_ff), dtype, device=device, stack=stack),
        "wu": dense_init(gen, (d_model, d_ff), dtype, device=device, stack=stack),
        "wd": dense_init(gen, (d_ff, d_model), dtype, device=device, stack=stack),
    }


def gated_mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = torch.matmul(x, params["wg"])
    u = torch.matmul(x, params["wu"])
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    return torch.matmul(a * u, params["wd"])
