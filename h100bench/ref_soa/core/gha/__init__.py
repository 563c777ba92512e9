"""Guided Hybrid Allocation (GHA) — the paper's offline compiler (§III-B).

GHA decomposes the joint spatio-temporal scheduling problem into three
phases plus a physical-binding step:

* :mod:`phase1` — chain-by-chain slack assignment (Algorithm 1):
  per-task shape ``(c_v, l_v)`` minimizing peak tile usage under the
  E2E deadline.
* :mod:`phase2` — spatial partitioning (Eq. 6-7): task-to-partition
  mapping ``x_vs`` and capacities ``|B_s|``.
* :mod:`phase3` — intra-partition temporal compaction (FFD repack,
  enforcing the total tile budget M).
* :mod:`guillotine` — physical partition binding (rectangular cuts +
  memory-controller affinity).
* :mod:`compiler` — the pipeline entry producing a :class:`Schedule`.
"""
from .schedule import PartitionPlan, Schedule, TaskPlan
from .compiler import GHACompiler, compile_schedule

__all__ = [
    "TaskPlan",
    "PartitionPlan",
    "Schedule",
    "GHACompiler",
    "compile_schedule",
]
