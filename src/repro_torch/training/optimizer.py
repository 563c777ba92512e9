"""AdamW in plain torch, with int8 gradient compression.

The reference's arithmetic, in float32 and in its order, on nested-dict
parameter trees.  The reference donates its buffers to a jitted update;
here each leaf is updated in place under ``torch.no_grad()``, and large
leaves a slice at a time, so the float32 temporaries of one update stay
at ~128 MB where a whole 32 x 3072 x 8192 leaf would make 3.2 GB each.

DTensor leaves (a trainer on a mesh) update their local shards with the
same arithmetic, each gradient first placed as its parameter; the
global norm sums the local slices in the same order and adds the ranks'
sums with one all-reduce, so a one-rank mesh gives the unsharded bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_grads_int8",
    "decompress_grads_int8",
    "global_norm",
    "tree_leaves",
]

#: elements per slice of an in-place update (float32: 128 MB per temporary)
_SLICE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    #: dtype of the m/v moments.  'bfloat16' halves the optimizer state.
    state_dtype: str = "float32"


def tree_leaves(tree) -> List[torch.Tensor]:
    """A nested dict's leaves in sorted-key order (the reference's pytree
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adamw_init(params, state_dtype: str = "float32") -> Dict[str, Any]:
    """Zero moments shaped as ``params`` in ``state_dtype``, and a step of
    0 (a 0-d int32 tensor on the CPU: the update reads it on the host)."""
    dt = getattr(torch, state_dtype)

    def zeros(p):
        if isinstance(p, DTensor):   # placed as its parameter
            return torch.zeros_like(p, dtype=dt, requires_grad=False)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "m": _tree_map(zeros, params),
        "v": _tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def _slices(*ts: torch.Tensor) -> Iterator[tuple]:
    """Matching flat slices of equally shaped contiguous tensors."""
    n = ts[0].numel()
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, _SLICE):
        yield tuple(f[i:i + _SLICE] for f in flat)


def _replicas(x: DTensor) -> int:
    """How many ranks of its mesh hold each element of ``x``."""
    return math.prod(n for p, n in zip(x.placements, x.device_mesh.shape) if p.is_replicate())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device).  DTensor leaves: each rank sums its local
    slices (a leaf held by r ranks enters at 1/r), then one all-reduce
    over the mesh."""
    total, mesh = None, None
    for x in tree_leaves(tree):
        w = 1
        if isinstance(x, DTensor):
            if any(p.is_partial() for p in x.placements):
                raise ValueError("global_norm takes reduced leaves, not partial sums")
            mesh, w, x = x.device_mesh, _replicas(x), x.to_local()
        for (c,) in _slices(x.contiguous()):
            sq = torch.sum(torch.square(c.float()))
            if w != 1:
                sq = sq / w
            total = sq if total is None else total + sq
    if mesh is not None:
        if total is None:   # every local shard empty
            total = torch.zeros((), dtype=torch.float32, device=mesh.device_type)
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim).full_tensor()
    return torch.sqrt(total)


def _placed_as(g, p):
    """A DTensor gradient placed as its parameter (a partial sum reduced)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local(*ts):
    """The local shards of equally placed DTensors (plain tensors as they are)."""
    return tuple(t.to_local() if isinstance(t, DTensor) else t for t in ts)


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warm-up, in float32: ``lr * min(step / warmup, 1)``."""
    warm = np.minimum(np.float32(step) / np.float32(max(cfg.warmup_steps, 1)), np.float32(1.0))
    return float(np.float32(cfg.lr) * warm)


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    overwritten and ``state["step"]`` advanced.  ``grads`` is a tree
    shaped as ``params`` (any float dtype).  Returns the gradients'
    global norm (before clipping), as the reference's third output."""
    step = int(state["step"]) + 1
    grads = _tree_map(_placed_as, grads, params)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = _schedule(cfg, step)
    c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    b1, b2, wd = cfg.b1, cfg.b2, cfg.weight_decay
    with torch.no_grad():
        for leaves in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
            p, g, m, v = _local(*leaves)
            for ps, gs, ms, vs in _slices(p, g.contiguous(), m, v):
                g32 = gs.float() * scale
                m2 = ms.float()
                m2.mul_(b1).add_(g32 * (1 - b1))
                v2 = vs.float()
                v2.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
                delta = (m2 / c1).div_((v2 / c2).sqrt_().add_(cfg.eps))
                delta.add_(ps.float() * wd)
                if m2 is not ms:
                    ms.copy_(m2)
                if v2 is not vs:
                    vs.copy_(v2)
                if ps.dtype == torch.float32:
                    ps.sub_(delta.mul_(lr))
                else:
                    ps.copy_(ps.float() - delta.mul_(lr))
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return gn


# ---------------------------------------------------------------------------
# gradient compression (cross-pod): int8 with per-tensor scale
# ---------------------------------------------------------------------------
def compress_grads_int8(grads):
    def enc(g):
        g32 = g.float()
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}

    return _tree_map(enc, grads)


def decompress_grads_int8(comp):
    if isinstance(comp, dict) and "q" in comp:
        return comp["q"].float() * comp["scale"]
    return {k: decompress_grads_int8(v) for k, v in comp.items()}
