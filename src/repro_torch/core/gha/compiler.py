"""The GHA compiler driver (paper §III-B, Fig. 4-5, Fig. 7 'offline').

``compile_schedule`` runs Phases I-III + physical binding and returns the
:class:`Schedule` (the scheduling table consumed by every runtime policy:
Cyc., Tp-driven and ADS-Tile all take their baseline operating point from
here — GHA is the *common adaptation layer*, §III-A3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..latency_model import LatencyModel
from ..workload import Workflow
from .guillotine import bind_memory_controllers, guillotine_cut
from .phase1 import run_phase1
from .phase2 import run_phase2
from .phase3 import run_phase3
from .schedule import PartitionPlan, Schedule, TaskPlan

__all__ = ["GHACompiler", "compile_schedule"]


@dataclasses.dataclass
class GHACompiler:
    """Configuration of the offline compiler.

    ``num_partitions=1`` yields the Tp-driven view (single shared bin);
    ``num_partitions=None`` keeps one bin per chain (the Cyc. view);
    intermediate values give ADS-Tile's configurable isolation domains.

    ``tile_budget`` caps the tiles the schedule may *reserve* below the
    hardware's ``M`` (Phases I and III solve against the budget; the
    mesh and ``Schedule.total_tiles`` stay the hardware's).  The
    tile-budget autotuner sweeps this to trace how few tiles a
    workload actually needs at a given service level — ``None`` keeps
    the classic full-chip compile.
    """

    q: float = 0.95
    num_partitions: Optional[int] = 4
    phase2_weights: Tuple[float, float, float] = (1.0, 2.0, 8.0)
    bind_physical: bool = True
    tile_budget: Optional[int] = None

    def compile(
        self,
        model: LatencyModel,
        wf: Workflow,
        warm_start: Optional[Dict[str, int]] = None,
    ) -> Schedule:
        """Run Phases I-III and bind; ``warm_start`` (task -> bin) seeds
        Phase II from a neighbouring compile's final partitioning."""
        hw = model.hw
        m = hw.num_tiles
        if self.tile_budget is not None:
            m = max(1, min(int(self.tile_budget), m))

        p1 = run_phase1(model, wf, self.q, tile_cap=m)

        n_parts = self.num_partitions
        if n_parts is None:
            n_parts = len(wf.chains)
        n_parts = max(1, min(n_parts, len(wf.dnn_tasks)))
        p2 = run_phase2(wf, p1, n_parts, self.phase2_weights, warm_start=warm_start)

        p3 = run_phase3(model, wf, p1, p2, m, self.q)

        # physical binding ------------------------------------------------
        # integer guillotine cuts need slack: near-100% packings are often
        # unrealisable with rectangles, so trade up to ~3% of capacity
        # (largest bins first) for bindability
        rects = None
        mcs = None
        caps = list(p3.capacities)
        if self.bind_physical and sum(caps) <= m:
            budget = max(1, int(0.03 * sum(caps)))
            for _ in range(budget + 1):
                try:
                    rects = guillotine_cut(hw.mesh_shape, caps)
                    mcs = bind_memory_controllers(rects, hw)
                    p3.capacities = caps
                    break
                except ValueError:
                    big = max(range(len(caps)), key=lambda i: caps[i])
                    if caps[big] <= 2:
                        break
                    caps[big] -= 1
            else:
                rects = mcs = None  # logical-only binding

        partitions = []
        for s, cap in enumerate(p3.capacities):
            partitions.append(
                PartitionPlan(
                    index=s,
                    capacity=cap,
                    rect=rects[s] if rects else None,
                    memory_controller=mcs[s] if mcs else None,
                )
            )

        plans = {}
        cap_of = {s: c for s, c in enumerate(p3.capacities)}
        for t, (c, l) in p3.shapes.items():
            if wf.tasks[t].is_sensor:
                continue
            part = p2.assignment[t]
            if c > cap_of[part]:  # capacity shrank for bindability
                cands = [x for x in wf.tasks[t].dop_candidates()
                         if x <= cap_of[part]]
                c = max(cands) if cands else min(wf.tasks[t].dop_candidates())
                l = model.bound(t, self.q, c)
            plans[t] = TaskPlan(
                task=t,
                partition=part,
                dop=c,
                budget_s=l,
                ert_s=p3.start_offsets[t],
            )

        sched = Schedule(
            plans=plans,
            partitions=partitions,
            q=self.q,
            total_tiles=hw.num_tiles,
            meta={
                "phase1_infeasible": p1.infeasible_chains,
                "phase3_violations": p3.deadline_violations,
                "phase2_score": p2.score,
                "num_partitions": len(partitions),
                "tile_budget": m,
            },
        )
        sched.validate()
        return sched


def compile_schedule(
    model: LatencyModel,
    wf: Workflow,
    q: float = 0.95,
    num_partitions: Optional[int] = 4,
) -> Schedule:
    return GHACompiler(q=q, num_partitions=num_partitions).compile(model, wf)
