"""Plain-torch oracles for the ported kernels (the allclose targets)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["attention_ref", "ssd_intra_chunk_ref", "rglru_scan_ref", "moe_gmm_ref"]

_C = 8.0  # RG-LRU's fixed temperature


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


def ssd_intra_chunk_ref(x, dt, A, Bm, Cm):
    """x (B,nb,C,H,P), dt (B,nb,C,H), A (H,), Bm/Cm (B,nb,C,N) — single
    group.  Returns (y_intra, contrib, chunk_decay) as f32."""
    c = x.shape[2]
    ack = torch.cumsum(dt.float() * A, dim=2)                        # (B,nb,C,H)
    seg = ack[:, :, :, None, :] - ack[:, :, None, :, :]              # (B,nb,C,C,H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.full_like(seg, -math.inf))
    decay = torch.exp(seg)
    cb = torch.einsum("bncm,bnsm->bncs", Cm.float(), Bm.float())
    w = cb[..., None] * decay * dt[:, :, None, :, :]
    y = torch.einsum("bncsh,bnshp->bnchp", w, x.float())
    d2e = torch.exp(ack[:, :, -1:, :] - ack)
    contrib = torch.einsum("bnch,bncm,bnchp->bnhpm", dt * d2e, Bm.float(), x.float())
    chunk_decay = torch.exp(ack[:, :, -1, :])
    return y, contrib, chunk_decay


def rglru_scan_ref(x, r, i, lam, h0):
    """Sequential-reference RG-LRU: x/r/i (B,L,W), lam (W,), h0 (B,W)."""
    log_a = -_C * F.softplus(lam.float())[None, None, :] * torch.sigmoid(r.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bterm = beta * torch.sigmoid(i.float()) * x.float()
    h = h0.float()
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + bterm[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def moe_gmm_ref(x, wg, wu, wd):
    h = torch.einsum("ecd,edf->ecf", x.float(), wg.float())
    u = torch.einsum("ecd,edf->ecf", x.float(), wu.float())
    a = F.silu(h) * u
    return torch.einsum(
        "ecf,efd->ecd", a.to(wd.dtype).float(), wd.float()
    ).to(x.dtype)
