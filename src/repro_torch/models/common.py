"""Shared NN substrate: init, norms, RoPE, chunked (flash-style)
attention, the gated MLP, the chunked cross-entropy and the activation
sharding constraint.

Functional torch over nested-dict parameter trees, in the reference's
layouts (attention is ``(B, H, L, D)``).  Attention's gradient is
:class:`repro_torch.kernels.flash_attention.FlashAttentionFn`, whose
plain backward is the reference's blockwise ``_flash_bwd``.

On a mesh the parameters are DTensors (``training/trainer.py``,
``launch/dryrun.py``) and so are the activations; ``ashard``
(:mod:`repro_torch.distribution.sharding`'s, exported here under the
reference's name with ``BATCH_AXES``) redistributes one to the
reference's activation layout, and is a no-op on a plain tensor, as the
reference's is outside a mesh.  The same model code runs on one device
and on the production mesh.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..distribution.sharding import BATCH_AXES, ashard, local_call, placements, to_placements

__all__ = [
    "ashard",
    "BATCH_AXES",
    "NEG_INF",
    "dense_init",
    "rms_norm",
    "rope",
    "chunked_attention",
    "gated_mlp_init",
    "gated_mlp",
    "chunked_xent",
]

NEG_INF = -1e30
_IMAX = torch.iinfo(torch.int32).max
#: most numbers ``dense_init`` draws at once for a stack (8 GiB in float32;
#: more than any stack of the archs ported before gemma2 and stablelm)
_DRAW_MAX = 1 << 31


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               scale: Optional[float] = None, *, device="cpu",
               stack: int = 0) -> torch.Tensor:
    """N(0, 1) * scale (default ``1/sqrt(fan_in)``, fan_in = ``shape[0]``)
    drawn in float32 from ``gen`` and cast to ``dtype``.  ``stack > 0``
    draws ``stack`` independent layers as one ``(stack, *shape)`` tensor.
    On the ``meta`` device only the shape and dtype are made.  A stack
    whose float32 draw would pass ``_DRAW_MAX`` numbers is drawn one layer
    at a time, so the float32 draw of a large model (gemma2-27b's MLP
    stack is 31 GB in float32) never exists whole."""
    fan_in = shape[0] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    full = ((stack,) if stack else ()) + tuple(shape)
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(full, dtype=dtype, device=dev)
    if stack and math.prod(full) > _DRAW_MAX:
        out = torch.empty(full, dtype=dtype, device=dev)
        for i in range(stack):
            out[i] = dense_init(gen, shape, dtype, scale, device=device)
        return out
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
    return_lse: bool = False,
):
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

    ``return_lse`` also returns the rows' log-sum-exp ``m + log(max(l,
    1e-30))``, (B, Hq, Lq) float32, which the backward reads.
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
    out = out.reshape(b, hq, lq, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(torch.clamp(l, min=1e-30))).reshape(b, hq, lq)
    return out


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
    h = ashard(h, BATCH_AXES, None, "model")
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    out = torch.matmul(a * u, params["wd"])
    return ashard(out, BATCH_AXES, None, None)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
class _MatmulF32Out(torch.autograd.Function):
    """``x @ emb.T`` of bf16 (B*S, D) and (V, D) on the card, kept in
    float32 (``torch.mm(..., out_dtype=float32)``, which autograd does not
    differentiate).  The backward takes the float32 cotangent to the
    inputs' dtype and runs two bf16 products with float32 sums, as a
    TPU's default-precision matmul takes the reference's float32
    cotangent: dx = g emb, demb = g^T x."""

    @staticmethod
    def forward(ctx, x, emb):
        ctx.save_for_backward(x, emb)
        return torch.mm(x, emb.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, emb = ctx.saved_tensors
        g = g.to(x.dtype)
        return torch.mm(g, emb), torch.mm(g.t(), x)


def _logits_f32(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """``x @ emb.T`` with float32 output, as the reference's einsum with
    ``preferred_element_type=float32``: a bf16 product on the card keeps
    its float32 sums; on the CPU the operands widen exactly."""
    if x.dtype == torch.float32 and emb.dtype == torch.float32:
        return torch.matmul(x, emb.t())
    if x.is_cuda:
        out = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), emb)
        return out.reshape(*x.shape[:-1], emb.shape[0])
    return torch.matmul(x.float(), emb.float().t())


def _logits_on_mesh(x: DTensor, emb: DTensor) -> DTensor:
    """:func:`_logits_f32` per shard: rows batch-sharded, the vocab sharded
    over 'model' (the reference's constraint on the logits block, which
    keeps a (B, chunk, 262k) float32 block off any one device)."""
    px = placements(x, (BATCH_AXES, None, None))
    pe = placements(emb, ("model", None))
    shape = (x.shape[0], x.shape[1], emb.shape[0])
    pl = to_placements((BATCH_AXES, None, "model"), x.device_mesh, shape)
    return local_call(_logits_f32, x.device_mesh, (x, emb), (px, pe), pl)


def _vocab_split(logits: torch.Tensor) -> bool:
    """Whether ``logits`` is a DTensor whose last (vocab) dim is split over
    more than one rank."""
    return isinstance(logits, DTensor) and any(
        p.is_shard(logits.dim() - 1) and n > 1
        for p, n in zip(logits.placements, logits.device_mesh.shape))


def _xent_chunk(xc: torch.Tensor, emb: torch.Tensor, lc: torch.Tensor, softcap: float):
    """Summed cross-entropy of one chunk over its valid (``>= 0``) labels,
    and their count.

    With the vocab split over ranks, the log-sum-exp takes
    ``torch.logsumexp``'s formula (max, then the sum of exponentials) in
    two partial reductions, and the gold logit the reference's one-hot
    contraction, so no rank gathers the whole vocab."""
    logits = _logits_on_mesh(xc, emb) if isinstance(xc, DTensor) else _logits_f32(xc, emb)
    logits = _apply_softcap(logits, softcap)
    idx = lc.clamp(min=0)
    if _vocab_split(logits):
        m = logits.amax(dim=-1, keepdim=True).detach()
        m = torch.where(m.abs() == math.inf, torch.zeros_like(m), m)
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m.squeeze(-1)
        gold = torch.sum(logits * F.one_hot(idx, logits.shape[-1]).to(logits.dtype), dim=-1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        # a gather, not the reference's one-hot contraction: equal for
        # finite logits, without another (B, chunk, V) float32 block
        gold = logits.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    valid = (lc >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_xent(
    x: torch.Tensor,            # (B, S, D) final hidden states
    emb: torch.Tensor,          # (V, D) output embedding
    labels: torch.Tensor,       # (B, S) integer; -1 carries no loss
    *,
    softcap: float = 0.0,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks, so the (B, S, V) logits
    never materialise: each chunk runs under ``torch.utils.checkpoint``,
    so its (B, chunk, V) float32 logits are recomputed in the backward
    pass rather than kept (V is 200 064 for phi4-mini)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    labels = labels.long()
    tot = cnt = None
    for c0 in range(0, s, chunk):
        t, n = checkpoint(_xent_chunk, x[:, c0:c0 + chunk], emb, labels[:, c0:c0 + chunk],
                          softcap, use_reentrant=False, preserve_rng_state=False)
        tot = t if tot is None else tot + t
        cnt = n if cnt is None else cnt + n
    return tot / torch.clamp(cnt, min=1.0)
