"""Multi-head Latent Attention (deepseek-v2 [arXiv:2405.04434]).

Queries go through a low-rank bottleneck (q_lora); keys and values are
rebuilt from a compressed latent ``c_kv`` (kv_lora_rank) plus one rope
key shared by every head.  The decode cache holds only ``(c_kv,
k_rope)``: 512 + 64 numbers per token at full width instead of ``2 * H *
d_h``.

A prefill rebuilds per-head keys from the latent, pads the values from
``v_head_dim`` to the query-key width and runs
:func:`repro_torch.kernels.ops.flash_attention` (the CUDA kernel on the
card) at Hq = Hkv = H, scale ``1/sqrt(dn + dr)``.  A one-token decode
against the cache runs the reference's absorbed form in plain torch (the
reference's too is plain einsums, outside any kernel).  The caches are
written in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..distribution.sharding import BATCH_AXES, ashard
from .common import NEG_INF, dense_init, rms_norm, rope
from .config import ModelConfig

__all__ = ["mla_init", "mla_apply", "init_mla_cache"]


def mla_init(gen, cfg: ModelConfig, *, device="cpu", stack: int = 0) -> Dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.torch_dtype
    kw = dict(device=device, stack=stack)
    lead = (stack,) if stack else ()
    return {
        "q_down": dense_init(gen, (d, qr), dt, **kw),
        "q_norm": torch.ones(lead + (qr,), dtype=dt, device=device),
        "q_up": dense_init(gen, (qr, h * (dn + dr)), dt, **kw),
        "kv_down": dense_init(gen, (d, kvr), dt, **kw),
        "kv_norm": torch.ones(lead + (kvr,), dtype=dt, device=device),
        "k_rope": dense_init(gen, (d, dr), dt, **kw),
        "k_up": dense_init(gen, (kvr, h * dn), dt, **kw),
        "v_up": dense_init(gen, (kvr, h * dv), dt, **kw),
        "wo": dense_init(gen, (h * dv, d), dt, **kw),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                   device="cpu") -> Dict:
    dt = cfg.torch_dtype
    return {
        "c_kv": torch.zeros((layers, batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
        "k_rope": torch.zeros((layers, batch, max_len, cfg.qk_rope_dim), dtype=dt, device=device),
    }


def _mm_f32(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` with a float32 result (the reference's
    ``preferred_element_type=float32``): the operands widen exactly."""
    return torch.einsum(eq, a.float(), b.float())


def _absorbed_decode(params, cfg, q_nope, q_rope, c_kv, k_rope, pos: int, b, h, dn, dr, dv):
    """Latent-space decode: one query token against the compressed cache.
    ``q_nope`` (B, 1, H, dn), ``q_rope`` (B, 1, H, dr) after rope; ``c_kv``
    (B, Lmax, r), ``k_rope`` (B, Lmax, dr).  ``k_up`` folds into the query
    and ``v_up`` into the output, so the scores run against the latent."""
    r = cfg.kv_lora_rank
    lmax = c_kv.shape[1]
    k_up = params["k_up"].reshape(r, h, dn)
    v_up = params["v_up"].reshape(r, h, dv)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], k_up)              # (B, H, r)
    s = _mm_f32(q_lat, c_kv, "bhr,blr->bhl") + _mm_f32(q_rope[:, 0], k_rope, "bhd,bld->bhl")
    s = s / math.sqrt(dn + dr)
    mask = torch.arange(lmax, device=s.device)[None, None, :] <= pos
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = _mm_f32(p.to(c_kv.dtype), c_kv, "bhl,blr->bhr")
    out_h = torch.einsum("bhr,rhd->bhd", ctx.to(v_up.dtype), v_up)
    return out_h.reshape(b, 1, h * dv)


def _whole_rows(t: torch.Tensor) -> torch.Tensor:
    """A low-rank projection's output gathered to whole rows on a mesh
    (it feeds norms, ropes and the caches); its gradient then reaches the
    projection's backward split as the projection's output is."""
    return ashard(t, BATCH_AXES, None, None)


def mla_apply(
    params: Dict,
    x: torch.Tensor,                   # (B, L, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,           # (L,) absolute positions
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (c_kv, k_rope): (B, Lmax, .)
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    b, l, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    # queries
    cq = rms_norm(_whole_rows(torch.matmul(x, params["q_down"])), params["q_norm"])
    q = torch.matmul(cq, params["q_up"]).reshape(b, l, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:].transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)                # (B, H, L, dn+dr)

    # compressed KV latent and the shared rope key
    c_kv = rms_norm(_whole_rows(torch.matmul(x, params["kv_down"])), params["kv_norm"])
    k_r = rope(_whole_rows(torch.matmul(x, params["k_rope"])), positions,
               cfg.rope_theta)                                             # (B, L, dr)

    new_cache = None
    kv_valid = None
    q_offset = 0
    if cache is not None:
        cc, cr = cache
        pos = 0 if cache_pos is None else int(cache_pos)
        # in place: ``cc``/``cr`` are views of the caller's stacked cache
        cc[:, pos:pos + l] = c_kv
        cr[:, pos:pos + l] = k_r
        new_cache = (cc, cr)
        if l == 1:
            out = _absorbed_decode(params, cfg, q_nope, q_rope, cc, cr, pos, b, h, dn, dr, dv)
            return torch.matmul(out, params["wo"]), new_cache
        # the keys past pos + l are masked: rebuild only the valid ones
        kv_valid = pos + l
        c_kv, k_r = cc[:, :kv_valid], cr[:, :kv_valid]
        q_offset = pos

    lk = c_kv.shape[1]
    k_nope = torch.matmul(c_kv, params["k_up"]).reshape(b, lk, h, dn)
    v = torch.matmul(c_kv, params["v_up"]).reshape(b, lk, h, dv)
    k = torch.cat([k_nope, k_r[:, :, None, :].expand(b, lk, h, dr)], dim=-1).transpose(1, 2)
    # pad the values up to the query-key width for the shared attention core
    v = F.pad(v.transpose(1, 2), (0, dn + dr - dv))
    attend = ops.flash_attention_grad if torch.is_grad_enabled() else ops.flash_attention
    out = attend(
        q, k.contiguous(), v.contiguous(), causal=True, window=0, softcap=0.0,
        scale=1.0 / math.sqrt(dn + dr), q_offset=q_offset, kv_offset=0,
        kv_valid_len=kv_valid,
    )[..., :dv]
    out = out.transpose(1, 2).reshape(b, l, h * dv)
    return torch.matmul(out, params["wo"]), new_cache
