"""One-call experiment runner: workload -> GHA -> policy -> Tile-stream.

This is the entry point used by the benchmark harness (one function per
paper figure) and by the examples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .baselines import CyclicPolicy, ElasticCyclicPolicy, TpDrivenPolicy
from .benchmark import make_ads_benchmark
from .gha import GHACompiler
from .hardware import simba_chip
from .latency_model import LatencyModel
from .runtime import AdsTilePolicy
from .sim import SimConfig, Simulator, SimReport
from .sim.policy import Policy
from .workload import Workflow

__all__ = [
    "ExperimentSpec", "run_experiment", "make_policy", "POLICIES",
    "build_stack",
]

POLICIES = (
    "cyc",            # static reservation, hard budgets (§III-A1)
    "cyc_s",          # elastic variant (ablation §V-B1)
    "tp_driven",      # work-conserving, single bin (§III-A2)
    "tp_driven_hard", # + sub-deadline dropping (Fig. 12 'hard')
    "pglb",           # work-conserving within N partitions (§V-B2)
    "reserv",         # partitions + elastic reservation, no slack share
    "ads_tile",       # the full system (§IV)
)


def make_policy(name: str) -> Policy:
    if name == "cyc":
        return CyclicPolicy()
    if name == "cyc_s":
        return ElasticCyclicPolicy()
    if name == "tp_driven":
        return TpDrivenPolicy()
    if name == "tp_driven_hard":
        return TpDrivenPolicy(drop_on_subddl=True)
    if name == "pglb":
        return TpDrivenPolicy()
    if name == "reserv":
        return AdsTilePolicy(slack_sharing=False)
    if name == "ads_tile":
        return AdsTilePolicy()
    raise ValueError(f"unknown policy {name!r} (choose from {POLICIES})")


@dataclasses.dataclass
class ExperimentSpec:
    policy: str = "ads_tile"
    tiles: int = 400
    cockpit_replicas: int = 1
    load_factor: float = 1.0
    deadline_s: float = 0.100
    q: float = 0.95
    num_partitions: Optional[int] = 4
    duration_s: float = 2.0
    seed: int = 0
    drop_policy: str = "soft"
    p99_ratio: float = 3.3
    dram_utilization: float = 0.5

    def resolved_partitions(self) -> Optional[int]:
        """Policy-implied partitioning: Tp-driven is single-bin by
        definition; Cyc. uses per-chain bins (S=None)."""
        if self.policy in ("tp_driven", "tp_driven_hard"):
            return 1
        if self.policy in ("cyc", "cyc_s"):
            return None
        return self.num_partitions


def build_stack(spec):
    """Workflow / hardware / latency model / GHA compiler construction
    shared by the stationary runner and the scenario runner.  ``spec``
    is any object with :class:`ExperimentSpec`'s workload fields (the
    scenario runner's spec qualifies)."""
    wf = make_ads_benchmark(
        cockpit_replicas=spec.cockpit_replicas,
        load_factor=spec.load_factor,
        critical_deadline_s=spec.deadline_s,
        cockpit_deadline_s=max(spec.deadline_s, 0.100),
    )
    hw = simba_chip(spec.tiles)
    model = LatencyModel.from_workflow(
        wf, hw, p99_ratio=spec.p99_ratio,
        dram_utilization=spec.dram_utilization,
    )
    compiler = GHACompiler(q=spec.q, num_partitions=spec.resolved_partitions())
    return wf, hw, model, compiler


def run_experiment(spec: ExperimentSpec) -> SimReport:
    wf, _hw, model, compiler = build_stack(spec)
    sched = compiler.compile(model, wf)
    policy = make_policy(spec.policy)
    sim = Simulator(
        wf, model, sched, policy,
        SimConfig(
            duration_s=spec.duration_s, seed=spec.seed,
            drop_policy=spec.drop_policy,
        ),
    )
    return sim.run()


def critical_map(wf: Workflow) -> Dict[str, bool]:
    return {c.name: c.critical for c in wf.chains}
