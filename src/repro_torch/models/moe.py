"""Mixture-of-Experts layer (granite-moe, deepseek-v2), single shard.

Token-choice top-k routing with capacity buckets, kept bit for bit from
the reference: float32 router, softmax, top-k, gate renormalisation,
``capacity = max(8, int(cf * k * T / E))``, token-major rank within an
expert by cumulative sum, one scatter per choice column, float32
combine.  The bucket FFN goes through
:func:`repro_torch.kernels.ops.moe_gmm`: the CUDA kernel on the card,
the plain version on the CPU.  Shared experts (deepseek-v2) are one
gated MLP of width ``moe_d_ff * num_shared_experts`` that every token
runs, added after the combine.

Expert parallelism (the reference's ``shard_map`` over the 'model' mesh
axis) comes with ``distribution/`` (ROADMAP: distribution/* and
launch/{mesh,dryrun}.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import ops
from .common import dense_init, gated_mlp, gated_mlp_init
from .config import ModelConfig

__all__ = ["moe_init", "route", "dispatch", "moe_apply"]


def moe_init(gen, cfg: ModelConfig, *, device="cpu", stack: int = 0) -> Dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = cfg.torch_dtype
    kw = dict(device=device, stack=stack)
    p = {
        "router": dense_init(gen, (d, e), torch.float32, scale=0.02, **kw),
        "wg": dense_init(gen, (e, d, f), dt, **kw),
        "wu": dense_init(gen, (e, d, f), dt, **kw),
        "wd": dense_init(gen, (e, f, d), dt, **kw),
    }
    if cfg.num_shared_experts:
        p["shared"] = gated_mlp_init(gen, d, f * cfg.num_shared_experts, dt, **kw)
    return p


def route(router: torch.Tensor, tokens: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` gates (renormalised, float32) and expert ids per token."""
    logits = torch.matmul(tokens.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def dispatch(ids: torch.Tensor, n_experts: int, cf: float
             ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Capacity, keep mask and bucket slot of each (token, choice).

    The rank of a (token, choice) within its expert is its token-major
    order; pairs at rank >= capacity are dropped to the overflow slot
    ``E * capacity``."""
    t, k = ids.shape
    capacity = max(8, int(cf * k * t / n_experts))
    onehot = torch.nn.functional.one_hot(ids.reshape(-1), n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot                     # rank + 1
    pos = (pos.sum(dim=1) - 1).reshape(t, k)
    keep = pos < capacity
    slot = torch.where(keep, ids * capacity + pos,
                       torch.full_like(ids, n_experts * capacity))
    return capacity, keep, slot


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(b * s, d)
    gates, ids = route(params["router"], tokens, k)
    capacity, keep, slot = dispatch(ids, e, cfg.moe_capacity_factor)

    # scatter tokens into buckets, one choice column at a time (kept
    # pairs of a column have distinct slots; dropped ones all hit the
    # overflow row, which is discarded)
    buckets = torch.zeros((e * capacity + 1, d), dtype=tokens.dtype, device=x.device)
    for j in range(k):
        buckets[slot[:, j]] = tokens
    be = buckets[:-1].reshape(e, capacity, d)

    out_e = ops.moe_gmm(be, params["wg"], params["wu"], params["wd"])
    flat_out = torch.cat(
        [out_e.reshape(e * capacity, d), torch.zeros((1, d), dtype=out_e.dtype, device=x.device)]
    )

    # combine back to token order with gate weights, per choice column
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        g = torch.where(keep[:, j], gates[:, j], torch.zeros_like(gates[:, j]))
        out = out + flat_out[slot[:, j]].float() * g[:, None]
    out = out.to(x.dtype).reshape(b, s, d)
    if "shared" in params:
        out = out + gated_mlp(params["shared"], x)
    return out
