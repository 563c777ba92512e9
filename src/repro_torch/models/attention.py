"""GQA attention block with KV cache, sliding-window/global alternation,
logit softcap and optional per-head QK-norm.

Attention goes through :func:`repro_torch.kernels.ops.flash_attention`:
the CUDA kernel on the card, the plain blockwise version on the CPU.
Caches are written in place (the reference returns updated copies); the
bounded-window ring cache (recurrentgemma) holds position ``p`` in slot
``p mod W``.
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
    ring: bool = False,                # bounded-window ring cache
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
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
        # so the writes land there
        new_cache = (ck, cv)
        if ring:
            out = _ring_attend(q, k, v, ck, cv, pos, window, cfg.attn_logit_softcap)
        else:
            ck[:, :, pos:pos + l] = k
            cv[:, :, pos:pos + l] = v
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


def _ring_attend(q, k, v, ck, cv, pos: int, window: int, softcap: float):
    """Attention through a ring cache of W slots that holds position ``p``
    in slot ``p mod W``; writes the new keys and values into it.

    Decode (one token): write slot ``pos mod W``, then attend over the
    ring, slot ``i`` at position ``pos - ((pos - i) mod W)`` (negative for
    a slot not yet written, which masks it).  Prefill: attend over the
    computed sequence itself, then fold its last ``min(l, W)`` rows into the
    ring: rolled into place when they fill it, else written from slot
    ``first mod W`` (start clamped to ``W - take``, as the reference's
    ``dynamic_update_slice`` clamps it)."""
    l, cache_len = q.shape[2], ck.shape[2]
    if l == 1:
        slot = pos % cache_len
        ck[:, :, slot:slot + 1] = k
        cv[:, :, slot:slot + 1] = v
        idx = torch.arange(cache_len, dtype=torch.int32, device=q.device)
        kpos = pos - torch.remainder(pos - idx, cache_len)
        return ops.flash_attention(q, ck, cv, causal=True, window=window, softcap=softcap,
                                   q_offset=pos, kv_positions=kpos)
    out = ops.flash_attention(q, k.contiguous(), v.contiguous(), causal=True, window=window,
                              softcap=softcap, q_offset=pos, kv_offset=pos)
    take = min(l, cache_len)
    k_tail, v_tail = k[:, :, l - take:], v[:, :, l - take:]
    first = pos + l - take                   # absolute position of tail[0]
    if take == cache_len:
        shift = first % cache_len
        ck.copy_(torch.roll(k_tail, shift, dims=2))
        cv.copy_(torch.roll(v_tail, shift, dims=2))
    else:
        start = min(first % cache_len, cache_len - take)
        ck[:, :, start:start + take] = k_tail
        cv[:, :, start:start + take] = v_tail
    return out
