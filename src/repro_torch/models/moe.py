"""Mixture-of-Experts layer (granite-moe, deepseek-v2).

Token-choice top-k routing with capacity buckets, kept bit for bit from
the reference: float32 router, softmax, top-k, gate renormalisation,
``capacity = max(8, int(cf * k * T / E))``, token-major rank within an
expert by cumulative sum, one scatter per choice column, float32
combine.  The bucket FFN goes through
:func:`repro_torch.kernels.ops.moe_gmm`: the CUDA kernel on the card,
the plain version on the CPU.  Shared experts (deepseek-v2) are one
gated MLP of width ``moe_d_ff * num_shared_experts`` that every token
runs, added after the combine.

Expert parallelism: on a DTensor whose mesh has a 'model' axis dividing
the expert count, the routed part runs under ``local_map`` (the
reference's ``shard_map``): tokens batch-sharded and replicated over
'model', ``wg``/``wu``/``wd`` sharded over 'model'; each model rank
dispatches its local token shard to its own experts ``[rank * e_local,
(rank + 1) * e_local)`` and returns a partial sum that one all-reduce
over 'model' combines.  The capacity counts the *local* T, as inside the
reference's ``shard_map``: a 'data' axis > 1 changes which tokens
overflow compared with one device.  On a mesh whose 'model' axis does
not divide E the routed part runs replicated on the whole token set.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial

from ..kernels import ops
from ..distribution.sharding import BATCH_AXES, ashard, local_call, placements
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


def dispatch(ids: torch.Tensor, n_experts: int, cf: float, e_base: int = 0,
             e_local: int = 0) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Capacity, keep mask and bucket slot of each (token, choice), for
    the local experts ``[e_base, e_base + e_local)`` of ``n_experts``
    (``e_local = 0``: all of them).

    The rank of a (token, choice) within its expert is its token-major
    order; pairs at rank >= capacity, and pairs routed to another rank's
    experts, go to the overflow slot ``e_local * capacity``."""
    t, k = ids.shape
    e_local = e_local or n_experts
    capacity = max(8, int(cf * k * t / n_experts))
    flat_e, cols = ids, n_experts
    if e_local < n_experts:   # other ranks' experts share one extra column
        local = ids - e_base
        in_range = (local >= 0) & (local < e_local)
        flat_e, cols = torch.where(in_range, local, torch.full_like(local, e_local)), e_local + 1
    onehot = torch.nn.functional.one_hot(flat_e.reshape(-1), cols).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot                     # rank + 1
    pos = (pos.sum(dim=1) - 1).reshape(t, k)
    keep = pos < capacity
    if e_local < n_experts:
        keep = keep & in_range
    slot = torch.where(keep, flat_e * capacity + pos,
                       torch.full_like(ids, e_local * capacity))
    return capacity, keep, slot


def _expert_compute(tokens, gates, ids, wg, wu, wd, cf: float, e_total: int,
                    e_base: int, e_local: int) -> torch.Tensor:
    """Dispatch ``tokens`` (T, D) to the local expert slice, run the bucket
    FFN and combine with the gates; returns (T, D) in the tokens' dtype."""
    t, d = tokens.shape
    k = ids.shape[1]
    capacity, keep, slot = dispatch(ids, e_total, cf, e_base, e_local)

    # scatter tokens into buckets, one choice column at a time (kept
    # pairs of a column have distinct slots; dropped ones all hit the
    # overflow row, which is discarded)
    buckets = torch.zeros((e_local * capacity + 1, d), dtype=tokens.dtype, device=tokens.device)
    for j in range(k):
        buckets[slot[:, j]] = tokens
    be = buckets[:-1].reshape(e_local, capacity, d)

    out_e = ops.moe_gmm(be, wg, wu, wd)
    flat_out = torch.cat([out_e.reshape(e_local * capacity, d),
                          torch.zeros((1, d), dtype=out_e.dtype, device=tokens.device)])

    # combine back to token order with gate weights, per choice column
    out = torch.zeros((t, d), dtype=torch.float32, device=tokens.device)
    for j in range(k):
        g = torch.where(keep[:, j], gates[:, j], torch.zeros_like(gates[:, j]))
        out = out + flat_out[slot[:, j]].float() * g[:, None]
    return out.to(tokens.dtype)


def _routed(x: torch.Tensor, router, wg, wu, wd, cfg: ModelConfig, e_base: int,
            e_local: int) -> torch.Tensor:
    """Route the (B, S, D) tokens of ``x`` and run the experts
    ``[e_base, e_base + e_local)``: (B, S, D)."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    gates, ids = route(router, tokens, cfg.experts_per_token)
    out = _expert_compute(tokens, gates, ids, wg, wu, wd, cfg.moe_capacity_factor,
                          cfg.num_experts, e_base, e_local)
    return out.reshape(b, s, d)


def _routed_on_mesh(params: Dict, x: DTensor, cfg: ModelConfig) -> DTensor:
    """The routed part under ``local_map``: expert-parallel over 'model'
    when it divides E (a partial sum per rank, all-reduced), else
    replicated on every token."""
    mesh = x.device_mesh
    args = (x, params["router"], params["wg"], params["wu"], params["wd"])
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    e = cfg.num_experts
    n_shards = sizes.get("model", 0)
    repl = placements(x, ())
    if n_shards and e % n_shards == 0:
        e_local = e // n_shards
        rank = mesh.get_local_rank("model")
        tok = placements(x, (BATCH_AXES, None, None))        # batch-sharded,
        expert = placements(params["wg"], ("model", None, None))  # experts over model
        out_pl = tuple(Partial() if n == "model" else p
                       for n, p in zip(mesh.mesh_dim_names, tok))

        def shard_fn(xl, router, wg, wu, wd):
            return _routed(xl, router, wg, wu, wd, cfg, rank * e_local, e_local)

        out = local_call(shard_fn, mesh, args, (tok, repl, expert, expert, expert), out_pl)
        return out.redistribute(mesh, tok)                   # psum over model

    def whole_fn(xl, router, wg, wu, wd):
        return _routed(xl, router, wg, wu, wd, cfg, 0, e)

    return local_call(whole_fn, mesh, args, (repl,) * 5, repl)


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if isinstance(x, DTensor):
        out = _routed_on_mesh(params, x, cfg)
    else:
        out = _routed(x, params["router"], params["wg"], params["wu"], params["wd"], cfg,
                      0, cfg.num_experts)
    if "shared" in params:
        out = out + gated_mlp(params["shared"], x)
    return ashard(out, BATCH_AXES, None, None)
