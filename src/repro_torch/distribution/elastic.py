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
from typing import List

__all__ = ["ElasticMesh", "StragglerMonitor"]


class ElasticMesh:
    def __init__(self, model_parallel: int = 1):
        raise NotImplementedError(
            "ElasticMesh is not ported yet: ROADMAP: distribution/* and "
            "launch/{mesh,dryrun}.py (A8)"
        )


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
