"""Elastic scaling & straggler mitigation.

:class:`StragglerMonitor` (the reference's, verbatim) keeps a per-step
wall-time EWMA and deviation, and flags steps that exceed ``k``
deviations, the trigger real deployments use to evict or re-mesh.

:class:`ElasticMesh`, which rebuilds a device mesh from the healthy
devices, is not ported yet: it raises, naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ElasticMesh", "StragglerMonitor"]


def _rank(d) -> int:
    """A rank, given as an int or as a device stub carrying ``.id``."""
    return int(getattr(d, "id", d))


class ElasticMesh:
    """``mesh_for(ranks=None)``: the mesh over ``ranks`` (default: every
    rank of the default process group, which must be initialised)."""

    def __init__(self, model_parallel: int = 1):
        self.model_parallel = model_parallel

    @staticmethod
    def grid(ranks: Sequence, model_parallel: int) -> np.ndarray:
        """The ``(usable // mp, mp)`` rank grid of ``ranks``."""
        ranks = [_rank(d) for d in ranks]
        mp = model_parallel
        usable = (len(ranks) // mp) * mp
        if usable == 0:
            raise RuntimeError(
                f"not enough devices ({len(ranks)}) for model_parallel={mp}"
            )
        return np.asarray(ranks[:usable]).reshape(usable // mp, mp)

    def mesh_for(self, ranks: Optional[Sequence] = None):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from ..launch.mesh import mesh_device_type

        if ranks is None:
            ranks = range(dist.get_world_size())
        grid = self.grid(ranks, self.model_parallel)
        return DeviceMesh(mesh_device_type(), grid.tolist(),
                          mesh_dim_names=("data", "model"))

    @staticmethod
    def shrink_grid(grid: np.ndarray, failed: Sequence) -> np.ndarray:
        failed_ids = {_rank(d) for d in failed}
        rows = [row for row in np.asarray(grid).reshape(grid.shape[0], -1)
                if not any(int(r) in failed_ids for r in row)]
        if not rows:
            raise RuntimeError("no healthy data-parallel rows remain")
        return np.stack(rows)

    def shrink(self, mesh, failed: Sequence):
        """New mesh excluding failed ranks (whole data-rows drop so the
        model-parallel groups stay intact)."""
        from torch.distributed.device_mesh import DeviceMesh

        grid = self.shrink_grid(mesh.mesh.cpu().numpy(), failed)
        return DeviceMesh(mesh.device_type, grid.tolist(),
                          mesh_dim_names=mesh.mesh_dim_names)


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0         # deviations
    alpha: float = 0.1             # EWMA factor
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.n < 5:  # warmup
            self.mean = (self.mean * self.n + dt_s) / (self.n + 1)
            self.n += 1
            return False
        dev = dt_s - self.mean
        std = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
        is_straggler = dev > self.threshold * max(std, 1e-9)
        self.mean += self.alpha * dev
        self.var = (1 - self.alpha) * (self.var + self.alpha * dev * dev)
        self.n += 1
        if is_straggler:
            self.flagged.append(step)
        return is_straggler
