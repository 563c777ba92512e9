"""GHA Phase II — Spatial Partitioning (paper §III-B3, Eq. 6-7).

Clusters tasks into S partitions ("bins"), trading off three criteria:

    min  w1 * sum_s |B_s|  -  w2 * Score_affinity  +  w3 * Score_balance

subject to one-bin-per-task (Eq. 6a) and per-window capacity (Eq. 6b,
which *defines* |B_s| = the bin's peak concurrent tile demand).

Implementation: chain-grouped initial assignment (mirroring Phase I's
chain-per-partition view), greedy bin merging down to the target S
(Fig. 5a: merge for affinity and for balance), then single-task local
search until a fixed point.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ...obs import metrics
from ..workload import Workflow, unroll_hyperperiod
from .phase1 import Phase1Result, chain_priority

__all__ = ["Phase2Result", "TimeWindows", "build_windows", "run_phase2"]


@dataclasses.dataclass
class TimeWindows:
    """Disjoint windows T splitting all task-interval boundaries; for each
    window, the per-task number of simultaneously active instances."""

    bounds: List[float]                      # len W+1
    active: List[Dict[str, int]]             # len W: task -> #active instances
    hyper_period_s: float

    @property
    def durations(self) -> List[float]:
        return [b - a for a, b in zip(self.bounds, self.bounds[1:])]


def build_windows(
    wf: Workflow,
    p1: Phase1Result,
    starts: Optional[Dict[str, float]] = None,
) -> TimeWindows:
    """Fold every task instance's planned interval into [0, T_hp) and cut
    the timeline at all interval boundaries."""
    thp = wf.hyper_period_s
    starts = starts if starts is not None else p1.start_offsets
    segments: List[Tuple[float, float, str]] = []
    for inst in unroll_hyperperiod(wf):
        task = inst.task
        if wf.tasks[task].is_sensor:
            continue  # sensors run on SPEs, not tiles
        s = inst.release_s + starts[task]
        e = s + p1.budget(task)
        s, e = s % thp, None
        dur = p1.budget(task)
        e = s + dur
        if e <= thp + 1e-12:
            segments.append((s, min(e, thp), task))
        else:  # wraps around
            segments.append((s, thp, task))
            segments.append((0.0, e - thp, task))

    cuts = sorted({0.0, thp, *(s for s, _, _ in segments), *(e for _, e, _ in segments)})
    bounds = [c for c in cuts if 0.0 <= c <= thp]
    active: List[Dict[str, int]] = []
    for a, b in zip(bounds, bounds[1:]):
        mid = 0.5 * (a + b)
        act: Dict[str, int] = {}
        for s, e, task in segments:
            if s - 1e-12 <= mid < e + 1e-12 and s < e:
                act[task] = act.get(task, 0) + 1
        active.append(act)
    return TimeWindows(bounds=bounds, active=active, hyper_period_s=thp)


@dataclasses.dataclass
class Phase2Result:
    assignment: Dict[str, int]          # task -> bin index (x_vs)
    capacities: List[int]               # |B_s|
    windows: TimeWindows
    score: float

    @property
    def num_partitions(self) -> int:
        return len(self.capacities)


class _Scorer:
    """Vectorised Eq. 7 evaluator.

    Precomputes the (task x window) tile-demand matrix once; a candidate
    partitioning is then scored with a handful of numpy reductions.  The
    three terms are normalised to comparable scales (capacity by M-like
    magnitude, affinity by |E|, balance in [0,1]) so the weights express
    actual trade-offs rather than unit mismatches.
    """

    def __init__(self, wf: Workflow, dops: Dict[str, int], windows: TimeWindows):
        import numpy as np

        self.np = np
        self.tasks = sorted(dops)
        self.index = {t: i for i, t in enumerate(self.tasks)}
        n, w = len(self.tasks), len(windows.active)
        demand = np.zeros((n, w))
        for j, act in enumerate(windows.active):
            for t, cnt in act.items():
                demand[self.index[t], j] = dops[t] * cnt
        self.demand = demand
        self.dur = np.asarray(windows.durations)
        self.thp = windows.hyper_period_s
        self.dop_vec = np.asarray([dops[t] for t in self.tasks])
        self.edges = [
            (self.index[u], self.index[v])
            for u, v in wf.edges
            if u in self.index and v in self.index
        ]
        self.norm_cap = max(1.0, float(self.dop_vec.sum()))
        #: bin -> (capacity, busy) memo: the greedy merge + local
        #: search re-evaluate mostly-unchanged partitionings, so the
        #: same bins recur thousands of times per compile
        self._stats_cache: Dict[tuple, Tuple[int, float]] = {}

    #: safety margin on sustained demand (runtime jitter headroom)
    SUSTAIN_MARGIN = 1.15

    def _bin_stats(self, b: List[str]) -> Tuple[int, float]:
        """(capacity, busy tile-seconds) of one bin — the expensive
        per-window demand aggregation, memoized on the bin's member set
        and shared by :meth:`capacities` and :meth:`score`."""
        key = tuple(sorted(b))
        hit = self._stats_cache.get(key)
        if hit is not None:
            return hit
        idx = sorted(self.index[t] for t in b)
        if not idx:
            self._stats_cache[key] = (0, 0.0)
            return 0, 0.0
        col = self.demand[idx].sum(axis=0)
        peak = float(col.max()) if len(self.dur) else 0.0
        peak = max(peak, float(self.dop_vec[idx].max()))
        # sustained tile demand: the bin must carry its members' total
        # tile-seconds per hyper-period even when planned offsets
        # interleave perfectly on paper but jitter at runtime
        busy = float((col * self.dur).sum())
        sustained = self.SUSTAIN_MARGIN * busy / self.thp
        out = (int(round(max(peak, sustained))), busy)
        self._stats_cache[key] = out
        return out

    def capacities(self, bins: List[List[str]]):
        return [self._bin_stats(b)[0] for b in bins]

    def score(
        self, bins: List[List[str]], w: Tuple[float, float, float]
    ) -> Tuple[float, List[int]]:
        w1, w2, w3 = w
        caps: List[int] = []
        busys: List[float] = []
        for b in bins:
            cap, busy = self._bin_stats(b)
            caps.append(cap)
            busys.append(busy)

        where = {}
        for s, b in enumerate(bins):
            for t in b:
                where[self.index[t]] = s
        affinity = sum(1 for u, v in self.edges if where[u] == where[v])

        utils = [
            busy / (cap * self.thp) if cap else 0.0
            for cap, busy in zip(caps, busys)
        ]
        balance = (max(utils) - min(utils)) if utils else 0.0
        # capacity-spread component: merged bins of similar size are
        # preferred over one mega-bin plus singletons (isolation domains
        # only bound reallocation if load is actually spread, §IV-B1)
        if caps:
            balance += (max(caps) - min(caps)) / self.norm_cap

        score = (
            w1 * sum(caps) / self.norm_cap
            - w2 * affinity / max(1, len(self.edges))
            + w3 * balance
        )
        return score, caps


def _warm_bins(
    warm_start: Dict[str, int], dops: Dict[str, int], target: int
) -> Optional[List[List[str]]]:
    """Rebuild Phase-II bins from a neighbouring cell's final assignment.

    Valid only when the assignment covers exactly this cell's task set
    and its group count matches the target bin count — otherwise the
    caller falls back to the cold chain-grouped construction."""
    if set(warm_start) != set(dops):
        return None
    groups: Dict[int, List[str]] = {}
    for t in sorted(dops):
        groups.setdefault(warm_start[t], []).append(t)
    if len(groups) != target:
        return None
    return [groups[g] for g in sorted(groups)]


def run_phase2(
    wf: Workflow,
    p1: Phase1Result,
    num_partitions: int,
    weights: Tuple[float, float, float] = (2.0, 1.0, 3.0),
    local_search_rounds: int = 4,
    warm_start: Optional[Dict[str, int]] = None,
) -> Phase2Result:
    """Partition tasks into ``num_partitions`` bins.

    ``num_partitions=1`` reproduces the Tp-driven single-bin view; larger
    values give the configurable-isolation domains of §IV-B1.

    ``warm_start`` (task -> bin) seeds the search with a neighbouring
    compile cell's final assignment, skipping the chain-grouped
    construction and the O(S²) greedy merge; the single-task local
    search still runs, so a warm start converges to the same fixed
    points the cold path reaches from a nearby basin.
    """
    dops = {t: c for t, (c, _) in p1.shapes.items() if not wf.tasks[t].is_sensor}
    windows = build_windows(wf, p1)
    scorer = _Scorer(wf, dops, windows)

    bins: Optional[List[List[str]]] = None
    if warm_start is not None:
        bins = _warm_bins(warm_start, dops, max(num_partitions, 1))
    if bins is not None:
        metrics.count("phase2_warm_start")
    else:
        metrics.count("phase2_cold_start")
        # -- initial: one bin per chain (priority order; first chain wins
        #    a shared task) ------------------------------------------------
        bins = []
        seen: set = set()
        for chain in sorted(wf.chains, key=lambda c: chain_priority(wf, c)):
            members = [
                n for n in chain.nodes
                if not wf.tasks[n].is_sensor and n not in seen
            ]
            if members:
                bins.append(members)
                seen.update(members)
        leftovers = [t for t in dops if t not in seen]
        if leftovers:
            bins.append(leftovers)

        # -- greedy merging down to the target S (Fig. 5a) ----------------
        while len(bins) > max(num_partitions, 1):
            best = None
            for i in range(len(bins)):
                for j in range(i + 1, len(bins)):
                    trial = [b for k, b in enumerate(bins) if k not in (i, j)]
                    trial.append(bins[i] + bins[j])
                    sc, _ = scorer.score(trial, weights)
                    if best is None or sc < best[0]:
                        best = (sc, i, j)
            _, i, j = best
            merged = bins[i] + bins[j]
            bins = [b for k, b in enumerate(bins) if k not in (i, j)]
            bins.append(merged)

    # -- local search: single-task moves ----------------------------------
    score, caps = scorer.score(bins, weights)
    for _ in range(local_search_rounds):
        improved = False
        for t in list(dops):
            src = next(i for i, b in enumerate(bins) if t in b)
            if len(bins[src]) == 1:
                continue
            for dst in range(len(bins)):
                if dst == src:
                    continue
                trial = [list(b) for b in bins]
                trial[src].remove(t)
                trial[dst].append(t)
                sc, c2 = scorer.score(trial, weights)
                if sc < score - 1e-9:
                    bins, score, caps = trial, sc, c2
                    improved = True
                    break
        if not improved:
            break

    assignment = {t: i for i, b in enumerate(bins) for t in b}
    return Phase2Result(
        assignment=assignment, capacities=caps, windows=windows, score=score
    )
