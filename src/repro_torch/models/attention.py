"""GQA attention block with KV cache, sliding-window/global alternation,
logit softcap and optional per-head QK-norm.

Attention goes through :func:`repro_torch.kernels.ops.flash_attention`:
the CUDA kernel on the card, the plain blockwise version on the CPU.
Without a cache and with grad enabled (the train path) it goes through
:func:`~repro_torch.kernels.ops.flash_attention_grad`, whose backward is
the backward kernel: autograd sees no kernel output as a leaf.
Caches are written in place (the reference returns updated copies); the
bounded-window ring cache (recurrentgemma) holds position ``p`` in slot
``p mod W``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..kernels import ops
from ..distribution.sharding import BATCH_AXES, ashard, local_call, model_split, placements
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


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, L, n * hd) -> (B, n, L, hd).  On a mesh whose 'model' axis does
    not divide ``n`` the projection (column-split over 'model') is
    gathered first: DTensor cannot unflatten a split dim whose leading
    factor the split does not divide (24 heads over 16 ranks)."""
    if isinstance(t, DTensor) and model_split(t, n) is None:
        t = ashard(t, BATCH_AXES, None, None)
    return t.reshape(t.shape[0], t.shape[1], n, hd).transpose(1, 2)


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

    q = _heads(torch.matmul(x, params["wq"]), hq, hd)
    k = _heads(torch.matmul(x, params["wk"]), hkv, hd)
    v = _heads(torch.matmul(x, params["wv"]), hkv, hd)

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
        attend = _cached_attend_on_mesh if isinstance(q, DTensor) else _cached_attend
        out = attend(q, k, v, ck, cv, pos, window, cfg.attn_logit_softcap, ring)
    else:
        attend = ops.flash_attention_grad if torch.is_grad_enabled() else ops.flash_attention
        out = attend(
            q, k.contiguous(), v.contiguous(), causal=True, window=window,
            softcap=cfg.attn_logit_softcap, q_offset=0, kv_offset=0,
        )

    # the row-parallel product's input split over 'model' (free where it
    # was replicated; its gradient then comes back whole, which an uneven
    # head split could not take)
    out = ashard(out.transpose(1, 2).reshape(b, l, hq * hd), BATCH_AXES, None, "model")
    return torch.matmul(out, params["wo"]), new_cache


def _cached_attend(q, k, v, ck, cv, pos: int, window: int, softcap: float, ring: bool,
                   kv=None):
    """Write the new keys and values into the cache (in place) and attend
    over it; the query heads read the key/value heads ``kv`` of it
    (:func:`~repro_torch.kernels.ops.query_heads`; None: all)."""
    if ring:
        return _ring_attend(q, k, v, ck, cv, pos, window, softcap, kv)
    l = q.shape[2]
    ck[:, :, pos:pos + l] = k
    cv[:, :, pos:pos + l] = v
    return ops.flash_attention(q, _pick(ck, kv), _pick(cv, kv), causal=True, window=window,
                               softcap=softcap, q_offset=pos, kv_offset=0,
                               kv_valid_len=pos + l)


def _pick(t: torch.Tensor, kv) -> torch.Tensor:
    """The key/value heads ``kv`` of (B, Hkv, M, D) ``t`` (None: all)."""
    return t if kv is None else t[:, kv].contiguous()


def _cached_attend_on_mesh(q, k, v, ck, cv, pos, window, softcap, ring):
    """:func:`_cached_attend` per shard: batch-sharded as the cache is, the
    heads over 'model' as :func:`~repro_torch.kernels.ops.query_heads`
    splits them.  Where the key/value heads do not split, every rank
    writes all of them and attends with its own query heads; a cache
    sharded otherwise (its sequence over 'model', ``cache_specs``'
    fallback) is gathered to those placements for the step and its new
    entries written back into this rank's shard."""
    mesh, hq = q.device_mesh, q.shape[1]
    heads = ops.query_heads(mesh, hq, k.shape[1])
    batch = BATCH_AXES if any(p.is_shard(0) for p in ck.placements) else None
    pq, out_pl = ops.query_placements(q, heads, batch, mesh)
    spec = (batch, "model" if heads is None else None, None, None)
    pk, pc = (placements(t, spec, mesh) for t in (k, ck))
    kept = [c if tuple(c.placements) == pc else c.redistribute(mesh, pc) for c in (ck, cv)]

    def fn(q_, *rest):
        if heads is None:
            return _cached_attend(q_, *rest, pos, window, softcap, ring)
        return _cached_attend(ops.own_queries(q_, heads), *rest, pos, window, softcap, ring,
                              heads.kv)

    out = local_call(fn, mesh, (q, k, v, *kept), (pq, pk, pk, pc, pc), out_pl)
    for c, w in zip((ck, cv), kept):
        if w is not c:
            c.to_local().copy_(w.redistribute(mesh, c.placements).to_local())
    return out if heads is None or heads.split else out[:, :hq]


def _ring_attend(q, k, v, ck, cv, pos: int, window: int, softcap: float, kv=None):
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
        return ops.flash_attention(q, _pick(ck, kv), _pick(cv, kv), causal=True,
                                   window=window, softcap=softcap, q_offset=pos,
                                   kv_positions=kpos)
    out = ops.flash_attention(q, _pick(k, kv).contiguous(), _pick(v, kv).contiguous(),
                              causal=True, window=window, softcap=softcap, q_offset=pos,
                              kv_offset=pos)
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
