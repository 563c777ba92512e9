"""Per-device cost counts of one traced step, the dry run's stand-in for
the reference's compiled-HLO accounting (``costs.weighted_costs`` and
``hlo.collective_bytes``).

:class:`StepCounter` is a ``TorchDispatchMode`` over a step that runs on
fake tensors (no byte allocated) on a fake process group.  It sees each
op once per execution, so layers, remat recomputes and the backward
count as executed, as the reference's loop weighting counts them:

* **flops**: ``torch.utils.flop_counter``'s formulas (FlopCounterMode's
  registry: matmuls, attention, convolutions).  An op on DTensors is
  counted at its global shape and divided by the ranks its output is
  split over (sharded or partial), the work each rank does; an op on
  plain tensors (inside ``local_map``: the kernels' plain versions, the
  MoE) is already a local op;
* **bytes**: each op's operand and result bytes, at the local shard
  sizes, views and metadata ops excluded.  Eager torch has no fusion, so
  this counts every op's traffic (more than XLA's fusion boundaries);
* **collectives**: the operand bytes of every ``_c10d_functional``
  collective, by the reference's kinds (its ``hlo.collective_bytes``
  rule); ``CommDebugMode`` counts the same ops.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["StepCounter", "COLLECTIVES"]

#: _c10d_functional op -> the reference's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
#: ops that move no data (beside views, which ``OpOverload.is_view`` flags)
_NO_DATA = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor", "device",
            "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim", "is_same_size",
            "_to_copy_meta", "empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "set_", "resize_"}


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(_local(t).numel() * _local(t).element_size()
               for t in leaves if isinstance(t, torch.Tensor))


def _split(out) -> int:
    """How many ranks share the work of an op whose output is ``out``: the
    product of the mesh dims the (first) DTensor output is sharded or
    partial over."""
    for t in tree_flatten(out)[0]:
        if isinstance(t, DTensor):
            return math.prod(n for p, n in zip(t.placements, t.device_mesh.shape)
                             if not p.is_replicate())
    return 1


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c: step()`` then ``c.counts()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective = {k: 0.0 for k in _KINDS}
        self.collective_ops = Counter()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                self.collective[kind] += _nbytes(args[0])
                self.collective_ops[kind] += 1
            return out
        if func.is_view or name in _NO_DATA or func.namespace == "prim":
            return out
        self.ops += 1
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:   # global shapes of DTensors, split over the ranks
            self.flops += formula(*args, **kwargs, out_val=out) / _split(out)
        return out

    def counts(self) -> Dict:
        coll = dict(self.collective)
        coll["total"] = sum(self.collective[k] for k in _KINDS)
        coll["count"] = float(sum(self.collective_ops.values()))
        return {"flops": self.flops, "bytes": self.bytes, "collective": coll,
                "collective_ops": dict(self.collective_ops), "ops": self.ops}
