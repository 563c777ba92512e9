"""Plain-torch oracles for the ported kernels (the allclose targets)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["attention_ref", "moe_gmm_ref"]


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """Naive full-materialisation GQA attention (q at offset 0, every key
    valid)."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    g = hq // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * sc
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window and window > 0:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(vv.dtype), vv)


def moe_gmm_ref(x, wg, wu, wd):
    h = torch.einsum("ecd,edf->ecf", x.float(), wg.float())
    u = torch.einsum("ecd,edf->ecf", x.float(), wu.float())
    a = F.silu(h) * u
    return torch.einsum(
        "ecf,efd->ecd", a.to(wd.dtype).float(), wd.float()
    ).to(x.dtype)
