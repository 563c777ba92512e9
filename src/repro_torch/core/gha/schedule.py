"""Schedule data structures produced by GHA and consumed by the runtime.

A :class:`Schedule` is the paper's "scheduling table": for every task its
partition ``x_vs``, offline DoP ``c_v``, latency budget ``l_v``, planned
start offset / Earliest-Ready-Time ``t_v`` and sub-deadline
``ddl_sub = t_v + l_v`` — all *relative to the activation of the chain's
source sensor* (instance-level absolute times are obtained by adding the
source sample timestamp; §II-C2, §IV-B).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

__all__ = ["TaskPlan", "PartitionPlan", "Schedule"]


@dataclasses.dataclass
class TaskPlan:
    task: str
    partition: int
    dop: int                    # c_v (offline tile allocation)
    budget_s: float             # l_v
    ert_s: float                # t_v (offset from source activation)
    # derived: sub-deadline offset
    @property
    def subdeadline_s(self) -> float:
        return self.ert_s + self.budget_s


@dataclasses.dataclass
class PartitionPlan:
    index: int
    capacity: int               # |B_s| in tiles
    rect: Optional[Tuple[int, int, int, int]] = None  # (row0, col0, h, w)
    memory_controller: Optional[int] = None

    @property
    def area(self) -> int:
        if self.rect is None:
            return self.capacity
        return self.rect[2] * self.rect[3]


@dataclasses.dataclass
class Schedule:
    plans: Dict[str, TaskPlan]
    partitions: List[PartitionPlan]
    q: float
    total_tiles: int
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def plan(self, task: str) -> TaskPlan:
        return self.plans[task]

    def partition_tasks(self, s: int) -> List[str]:
        return [t for t, p in self.plans.items() if p.partition == s]

    @property
    def peak_tiles(self) -> int:
        return sum(p.capacity for p in self.partitions)

    def validate(self) -> None:
        caps = {p.index: p.capacity for p in self.partitions}
        for name, plan in self.plans.items():
            if plan.partition not in caps:
                raise ValueError(f"{name}: unknown partition {plan.partition}")
            if plan.dop > caps[plan.partition]:
                raise ValueError(
                    f"{name}: dop {plan.dop} exceeds partition capacity "
                    f"{caps[plan.partition]}"
                )
            if plan.budget_s <= 0:
                raise ValueError(f"{name}: non-positive budget")
        if self.peak_tiles > self.total_tiles:
            raise ValueError(
                f"partition capacities {self.peak_tiles} exceed M={self.total_tiles}"
            )

    # -- (de)serialisation -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "q": self.q,
                "total_tiles": self.total_tiles,
                "plans": {
                    t: dataclasses.asdict(p) for t, p in self.plans.items()
                },
                "partitions": [dataclasses.asdict(p) for p in self.partitions],
                "meta": self.meta,
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "Schedule":
        d = json.loads(text)
        return cls(
            plans={t: TaskPlan(**p) for t, p in d["plans"].items()},
            partitions=[
                PartitionPlan(
                    index=p["index"], capacity=p["capacity"],
                    rect=tuple(p["rect"]) if p.get("rect") else None,
                    memory_controller=p.get("memory_controller"),
                )
                for p in d["partitions"]
            ],
            q=d["q"],
            total_tiles=d["total_tiles"],
            meta=d.get("meta", {}),
        )
