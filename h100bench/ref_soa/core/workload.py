"""Workload model: DAG, periodic sensors, chains, hyper-period (paper §II-C2).

An ADS workflow is a DAG ``G(V, E)`` with ``V = V_sen ∪ V_dnn``.  Sensor
tasks are activated by hardware timers at strictly periodic rates; DNN
tasks are data-driven (ready when all predecessors complete).  Because all
data originates from periodic sensors, dependency patterns repeat over the
hyper-period ``T_hp = lcm{T_v}`` and the DAG unrolls into task *instances*
with a static dependency structure (Fig. 2b-c).

Times are in **seconds** throughout the core.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from fractions import Fraction
from functools import reduce
from typing import (
    Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union,
)

__all__ = [
    "Task",
    "SensorTask",
    "DnnTask",
    "Chain",
    "Workflow",
    "TaskInstance",
    "unroll_hyperperiod",
    "clear_unroll_cache",
]


@dataclasses.dataclass(frozen=True)
class Task:
    """A node of the workflow DAG."""

    name: str
    # mean arithmetic workload per job, in FLOPs (W_v's location parameter)
    mean_flops: float = 0.0
    # bytes checkpointed on a DoP switch (weights + live features)
    checkpoint_bytes: float = 0.0
    # mean fraction of aggregate DRAM bandwidth this task consumes (Fig. 10)
    avg_bw_frac: float = 0.0
    # peak instantaneous DRAM bandwidth demand, bytes/s (Fig. 10)
    peak_bw: float = 0.0
    # valid pre-compiled DoP candidates (c_v^compiled); empty = any in range
    compiled_dops: Tuple[int, ...] = ()
    # inclusive DoP bounds when compiled_dops is empty
    min_dop: int = 1
    max_dop: int = 64
    # model family tag (for reporting only)
    model: str = ""

    @property
    def is_sensor(self) -> bool:
        return False

    def dop_candidates(self, cap: Optional[int] = None) -> Tuple[int, ...]:
        cands = self.compiled_dops or tuple(range(self.min_dop, self.max_dop + 1))
        if cap is not None:
            kept = tuple(c for c in cands if c <= cap)
            cands = kept or (min(cands),)
        return cands


@dataclasses.dataclass(frozen=True)
class SensorTask(Task):
    """Periodic source task, executed on a dedicated SPE (not on tiles)."""

    period_s: float = 0.1  # 1/rate
    # preprocessing latency distribution handled by the latency model;
    # mean latency kept here for quick estimates.
    mean_latency_s: float = 1e-3

    @property
    def is_sensor(self) -> bool:
        return True

    @property
    def rate_hz(self) -> float:
        return 1.0 / self.period_s


@dataclasses.dataclass(frozen=True)
class DnnTask(Task):
    """Data-driven DNN inference task running on tiles."""


@dataclasses.dataclass(frozen=True)
class Chain:
    """An end-to-end chain: sensor source -> ... -> actuator/display sink."""

    name: str
    nodes: Tuple[str, ...]            # task names, topological along the path
    deadline_s: float                 # E2E latency constraint D_e2e
    critical: bool = False            # safety-critical (driving) vs cockpit

    def __post_init__(self) -> None:
        if len(self.nodes) < 2:
            raise ValueError(f"chain {self.name} needs >=2 nodes")


def _lcm(values: Iterable[int]) -> int:
    return reduce(math.lcm, values, 1)


@dataclasses.dataclass
class Workflow:
    """The workflow DAG with its E2E chains."""

    tasks: Dict[str, Task]
    edges: List[Tuple[str, str]]
    chains: List[Chain]

    def __post_init__(self) -> None:
        for u, v in self.edges:
            if u not in self.tasks or v not in self.tasks:
                raise ValueError(f"edge ({u},{v}) references unknown task")
        for ch in self.chains:
            for n in ch.nodes:
                if n not in self.tasks:
                    raise ValueError(f"chain {ch.name} references unknown task {n}")
            for a, b in zip(ch.nodes, ch.nodes[1:]):
                if (a, b) not in set(self.edges):
                    raise ValueError(
                        f"chain {ch.name}: ({a},{b}) is not an edge of G"
                    )
        self._preds: Dict[str, List[str]] = {n: [] for n in self.tasks}
        self._succs: Dict[str, List[str]] = {n: [] for n in self.tasks}
        for u, v in self.edges:
            self._preds[v].append(u)
            self._succs[u].append(v)
        self._check_acyclic()
        # hot-path caches (the simulator queries these per job / per
        # completion): chain membership, chain sinks, tightest E2E
        # deadline offsets, task rates, the hyper-period, and the
        # structural signature used as the unroll/skeleton cache key.
        self._chains_of: Dict[str, List[Chain]] = {
            n: [c for c in self.chains if n in c.nodes] for n in self.tasks
        }
        self._chains_ending: Dict[str, List[Chain]] = {
            n: [c for c in self._chains_of[n] if c.nodes[-1] == n]
            for n in self.tasks
        }
        self._ddl_off: Dict[str, float] = {
            n: min((c.deadline_s for c in self._chains_of[n]), default=math.inf)
            for n in self.tasks
        }
        self._rate_cache: Dict[str, float] = {}
        self._hp_cache: Optional[float] = None
        self._signature: Optional[tuple] = None

    # -- graph helpers ----------------------------------------------------
    def preds(self, name: str) -> List[str]:
        return self._preds[name]

    def succs(self, name: str) -> List[str]:
        return self._succs[name]

    @property
    def sensor_tasks(self) -> List[SensorTask]:
        return [t for t in self.tasks.values() if isinstance(t, SensorTask)]

    @property
    def dnn_tasks(self) -> List[Task]:
        return [t for t in self.tasks.values() if not t.is_sensor]

    def topological_order(self) -> List[str]:
        indeg = {n: len(self._preds[n]) for n in self.tasks}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in sorted(self._succs[n]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
            ready.sort()
        return order

    def _check_acyclic(self) -> None:
        if len(self.topological_order()) != len(self.tasks):
            raise ValueError("workflow graph has a cycle")

    # -- timing -----------------------------------------------------------
    @property
    def hyper_period_s(self) -> float:
        """T_hp = lcm of the sensor periods (exact rational arithmetic —
        1/30 s is not integral in any fixed unit)."""
        if self._hp_cache is not None:
            return self._hp_cache
        if not self.sensor_tasks:
            raise ValueError("workflow has no sensor tasks")
        fracs = [Fraction(t.period_s).limit_denominator(10**9) for t in self.sensor_tasks]
        num = _lcm(f.numerator for f in fracs)
        den = reduce(math.gcd, (f.denominator for f in fracs))
        self._hp_cache = float(Fraction(num, den))
        return self._hp_cache

    @property
    def structural_signature(self) -> tuple:
        """Hashable identity of everything the unrolled instance graph
        depends on: tasks (with sensor periods), edges, and chains.  Two
        workflows with equal signatures unroll identically, so this is
        the cache key for :func:`unroll_hyperperiod` memoization and for
        the simulator's trace-skeleton cache (mode transforms build a
        *new* ``Workflow`` per call, so identity comparison is useless
        across runs)."""
        if self._signature is None:
            self._signature = (
                tuple(sorted(
                    (t.name, t.period_s if t.is_sensor else None)
                    for t in self.tasks.values()
                )),
                tuple(self.edges),
                tuple((c.name, c.nodes, c.deadline_s) for c in self.chains),
            )
        return self._signature

    def task_rate_hz(self, name: str) -> float:
        """Effective activation rate of a task: max of its source sensor
        rates along any path (a DNN task fires when all predecessors have a
        fresh job; the slowest upstream sensor gates the rate, matching the
        event-time alignment of §IV-C)."""
        cached = self._rate_cache.get(name)
        if cached is not None:
            return cached
        task = self.tasks[name]
        if isinstance(task, SensorTask):
            rate = task.rate_hz
        else:
            preds = self._preds[name]
            if not preds:
                raise ValueError(f"DNN task {name} has no predecessors")
            rate = min(self.task_rate_hz(p) for p in preds)
        self._rate_cache[name] = rate
        return rate

    def chain_for(self, name: str) -> List[Chain]:
        return self._chains_of[name]

    def chains_ending_at(self, name: str) -> List[Chain]:
        """Chains whose sink is ``name`` (the simulator's completion
        accounting runs this per finished job)."""
        return self._chains_ending[name]

    def deadline_offset(self, name: str) -> float:
        """Tightest E2E deadline through ``name`` over all its chains
        (``inf`` for tasks on no chain)."""
        return self._ddl_off[name]

    @property
    def sensor_periods(self) -> Dict[str, float]:
        """``{sensor name: period_s}`` — the rate signature of the
        workflow (two workflows with equal signatures unroll alike)."""
        return {t.name: t.period_s for t in self.sensor_tasks}

    def with_sensor_rates(self, periods: Mapping[str, float]) -> "Workflow":
        """Re-derive the workflow with new sensor periods (per-mode rate
        modulation: camera 30->15 Hz at night, radar 10->20 Hz in rain).

        ``periods`` maps sensor task names to their new ``period_s``;
        the DAG, chains and every DNN task are untouched.  Returns
        ``self`` when nothing effectively changes, so regime detection
        can compare identity cheaply.
        """
        for name, p in periods.items():
            task = self.tasks.get(name)
            if task is None or not task.is_sensor:
                raise ValueError(f"{name!r} is not a sensor task")
            if p <= 0:
                raise ValueError(f"{name}: non-positive period {p}")
        changed = {
            n: float(p) for n, p in periods.items()
            if not math.isclose(self.tasks[n].period_s, p, rel_tol=1e-12)
        }
        if not changed:
            return self
        tasks = dict(self.tasks)
        for n, p in changed.items():
            tasks[n] = dataclasses.replace(tasks[n], period_s=p)
        return Workflow(tasks=tasks, edges=list(self.edges), chains=list(self.chains))

    def replicate_cockpit(self, factor: int, cockpit_chain_names: Sequence[str]) -> "Workflow":
        """Scale workload by replicating cockpit pipelines (paper §V-A,
        nodes 11-14).  A node is replicated only if *every* chain it
        belongs to is being replicated — shared upstream stages (image
        backbones, sensors) stay shared across replicas."""
        if factor <= 1:
            return self
        cockpit = set(cockpit_chain_names)
        replicable = {
            n for n in self.tasks
            if not self.tasks[n].is_sensor
            and (cs := self.chain_for(n))
            and all(c.name in cockpit for c in cs)
        }
        tasks = dict(self.tasks)
        edges = list(self.edges)
        chains = list(self.chains)
        for k in range(1, factor):
            for cname in cockpit_chain_names:
                chain = next(c for c in self.chains if c.name == cname)
                mapping: Dict[str, str] = {}
                for node in chain.nodes:
                    if node not in replicable:
                        mapping[node] = node  # shared stage
                        continue
                    new_name = f"{node}#r{k}"
                    mapping[node] = new_name
                    if new_name not in tasks:
                        tasks[new_name] = dataclasses.replace(
                            self.tasks[node], name=new_name
                        )
                for a, b in zip(chain.nodes, chain.nodes[1:]):
                    e = (mapping[a], mapping[b])
                    if e not in edges:
                        edges.append(e)
                chains.append(
                    dataclasses.replace(
                        chain,
                        name=f"{cname}#r{k}",
                        nodes=tuple(mapping[n] for n in chain.nodes),
                    )
                )
        return Workflow(tasks=tasks, edges=edges, chains=chains)


@dataclasses.dataclass(frozen=True)
class TaskInstance:
    """One job of a task inside the hyper-period (e.g. A0, A1 in Fig. 2)."""

    task: str
    index: int                        # 0..N_v-1
    release_s: float                  # activation offset within T_hp
    preds: Tuple[Tuple[str, int], ...]  # (task, index) instance-level deps

    @property
    def key(self) -> Tuple[str, int]:
        return (self.task, self.index)


#: memoized unroll segments keyed on (structural signature, t0, t1,
#: phase).  Monte-Carlo sweeps re-unroll the same workflow segments for
#: every policy / replan variant / scenario sharing a regime; the cache
#: makes repeats free.  Bounded FIFO so unbounded scenario diversity
#: cannot leak memory.  Cached lists are shared — callers must treat
#: them as immutable (TaskInstance is frozen; the engine only iterates).
_UNROLL_CACHE: "OrderedDict[tuple, List[TaskInstance]]" = OrderedDict()
_UNROLL_CACHE_MAX = 256


def clear_unroll_cache() -> None:
    """Drop all memoized unroll segments (test isolation hook)."""
    _UNROLL_CACHE.clear()


def unroll_hyperperiod(
    wf: Workflow,
    t0: float = 0.0,
    t1: Optional[float] = None,
    phase_s: Union[float, Mapping[str, float]] = 0.0,
) -> List[TaskInstance]:
    """Unroll the DAG over a segment ``[t0, t1)`` (paper §II-C2).

    With the defaults this is one hyper-period starting at 0: each task
    ``v`` decomposes into ``N_v = T_hp / T_v`` instances.  A DNN instance
    depends on the *latest* instance of each predecessor released at or
    before its own release (event-time matching, §IV-C).

    Passing ``t0``/``t1`` unrolls an arbitrary segment with *absolute*
    release times: sensor timers are re-anchored at ``t0 + phase_s``
    (``phase_s`` is normalised into one period), which is what a
    mid-run sensor-rate change does — the hardware timers restart at
    the regime boundary, and the piecewise unrollings on either side
    share no instances (no double-released, no lost jobs).  ``t1 - t0``
    need not be a multiple of the hyper-period.

    ``phase_s`` may also be a mapping ``{sensor name: phase}``: only
    the listed sensors re-anchor at ``t0 + phase``, the rest stay on
    the ``t0`` grid.  This is what a *rate seam* needs — the modulated
    sensor's hardware timer restarts at the seam, but an unmodulated
    sensor keeps its own cadence across it (see
    :func:`h100bench.ref_soa.core.sim.trace.build_skeleton`); a sensor missing from
    the mapping gets phase 0.
    """
    if t1 is None:
        t1 = t0 + wf.hyper_period_s
    if t1 <= t0:
        raise ValueError(f"empty unroll segment [{t0}, {t1})")
    per_sensor = isinstance(phase_s, Mapping)
    phase_key = (
        tuple(sorted(phase_s.items())) if per_sensor else phase_s
    )
    key = (wf.structural_signature, t0, t1, phase_key)
    cached = _UNROLL_CACHE.get(key)
    if cached is not None:
        _UNROLL_CACHE.move_to_end(key)
        return cached
    instances: List[TaskInstance] = []
    releases: Dict[str, List[float]] = {}

    for name in wf.topological_order():
        task = wf.tasks[name]
        if isinstance(task, SensorTask):
            period = task.period_s
            ph = phase_s.get(name, 0.0) if per_sensor else phase_s
            first = t0 + (ph % period if ph else 0.0)
            n = max(0, int(math.ceil((t1 - first) / period - 1e-9)))
            releases[name] = [
                r for r in (first + i * period for i in range(n))
                if r < t1 - 1e-12
            ]
        else:
            preds = wf.preds(name)
            # release times = those of the rate-gating (slowest) predecessor
            gate = min(preds, key=lambda p: wf.task_rate_hz(p))
            releases[name] = list(releases[gate])

    for name in wf.topological_order():
        task = wf.tasks[name]
        for i, rel in enumerate(releases[name]):
            deps: List[Tuple[str, int]] = []
            if not task.is_sensor:
                for p in wf.preds(name):
                    # latest predecessor instance with release <= rel
                    cand = [j for j, r in enumerate(releases[p]) if r <= rel + 1e-12]
                    if cand:
                        deps.append((p, cand[-1]))
                    # else: the predecessor has not sampled yet in this
                    # segment (possible only with per-sensor phase
                    # offsets); the instance runs without that input
                    # rather than depending on a *future* sample
            instances.append(
                TaskInstance(task=name, index=i, release_s=rel, preds=tuple(deps))
            )
    _UNROLL_CACHE[key] = instances
    while len(_UNROLL_CACHE) > _UNROLL_CACHE_MAX:
        _UNROLL_CACHE.popitem(last=False)
    return instances
