"""GQA attention block with KV cache, sliding-window/global alternation,
logit softcap and optional per-head QK-norm.

Attention goes through :func:`repro_torch.kernels.ops.flash_attention`:
the CUDA kernel on the card, the plain blockwise version on the CPU.
The bounded-window ring cache (recurrentgemma) is not ported yet
(ROADMAP B4).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .common import dense_init, rms_norm, rope
from .config import ModelConfig

__all__ = ["attn_init", "attn_apply"]


def attn_init(gen, cfg: ModelConfig, *, device="cpu", stack: int = 0) -> Dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    kw = dict(device=device, stack=stack)
    p = {
        "wq": dense_init(gen, (d, hq * hd), dt, **kw),
        "wk": dense_init(gen, (d, hkv * hd), dt, **kw),
        "wv": dense_init(gen, (d, hkv * hd), dt, **kw),
        "wo": dense_init(gen, (hq * hd, d), dt, **kw),
    }
    if cfg.qk_norm:
        lead = (stack,) if stack else ()
        p["qn"] = torch.ones(lead + (hd,), dtype=dt, device=device)
        p["kn"] = torch.ones(lead + (hd,), dtype=dt, device=device)
    return p


def attn_apply(
    params: Dict,
    x: torch.Tensor,                   # (B, L, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,           # (L,) absolute positions
    window: int,                       # <= 0 global
    theta: float,                      # rope base
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,Hkv,Lmax,D)
    cache_pos: Optional[int] = None,   # #valid entries already
    ring: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    if ring:
        raise NotImplementedError(
            "the bounded-window ring cache is not ported yet: ROADMAP B4 "
            "(recurrentgemma_9b serving)"
        )
    b, l, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = torch.matmul(x, params["wq"]).reshape(b, l, hq, hd).transpose(1, 2)
    k = torch.matmul(x, params["wk"]).reshape(b, l, hkv, hd).transpose(1, 2)
    v = torch.matmul(x, params["wv"]).reshape(b, l, hkv, hd).transpose(1, 2)

    if cfg.qk_norm:
        q = rms_norm(q, params["qn"])
        k = rms_norm(k, params["kn"])
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)

    new_cache = None
    if cache is not None:
        ck, cv = cache
        pos = 0 if cache_pos is None else int(cache_pos)
        # in place: ``ck``/``cv`` are views of the caller's stacked cache,
        # so the write lands there (the reference returns updated copies)
        ck[:, :, pos:pos + l] = k
        cv[:, :, pos:pos + l] = v
        new_cache = (ck, cv)
        out = ops.flash_attention(
            q, ck, cv, causal=True, window=window,
            softcap=cfg.attn_logit_softcap,
            q_offset=pos, kv_offset=0, kv_valid_len=pos + l,
        )
    else:
        out = ops.flash_attention(
            q, k.contiguous(), v.contiguous(), causal=True, window=window,
            softcap=cfg.attn_logit_softcap, q_offset=0, kv_offset=0,
        )

    out = out.transpose(1, 2).reshape(b, l, hq * hd)
    return torch.matmul(out, params["wo"]), new_cache
