"""GHA Phase I — Chain-by-Chain Slack Assignment (paper §III-B2, Alg. 1).

Each E2E chain is isolated into its own (logical) partition with tasks
executing sequentially; per chain we determine the shape ``(c_v, l_v)``
of every task by solving

    min   max_v c_v                                   (Eq. 3)
    s.t.  sum_v l_v <= D_rem                          (Eq. 4a, chain form)
          l_v >= L_v(q, c_v)                          (Eq. 5a)
          c_v in c_v^compiled                         (Eq. 5b)

Chains are processed in priority order; previously assigned nodes keep
their allocation and consume part of the remaining deadline on later
chains (Alg. 1).  Start offsets then follow from a topological pass
(Alg. 1 lines 10-14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..latency_model import LatencyModel
from ..workload import Chain, Workflow

__all__ = ["Phase1Result", "solve_subchain", "run_phase1"]


@dataclasses.dataclass
class Phase1Result:
    # task -> (c_v, l_v); sensors get c_v = 0
    shapes: Dict[str, Tuple[int, float]]
    # task -> planned start offset s_v (relative to source activation)
    start_offsets: Dict[str, float]
    # chains whose deadline could not be met even at max DoP
    infeasible_chains: List[str]

    def dop(self, task: str) -> int:
        return self.shapes[task][0]

    def budget(self, task: str) -> float:
        return self.shapes[task][1]


def _best_latency_under_cap(
    model: LatencyModel, wf: Workflow, task: str, cap: int, q: float
) -> Tuple[Optional[int], float]:
    """(argmin-latency DoP <= cap, its latency); (None, inf) if no
    candidate fits the cap."""
    t = wf.tasks[task]
    best_c, best_l = None, float("inf")
    for c in t.dop_candidates():
        if c > cap:
            continue
        lat = model.bound(task, q, c)  # (task, q, c)-cached
        if lat < best_l:
            best_c, best_l = c, lat
    return best_c, best_l


def solve_subchain(
    model: LatencyModel,
    wf: Workflow,
    unassigned: Sequence[str],
    d_rem: float,
    q: float,
    tile_cap: int,
) -> Tuple[Dict[str, Tuple[int, float]], bool]:
    """SolveSubChain (Alg. 1 line 8): minimize peak tiles subject to
    ``sum l_v <= d_rem`` for the unassigned nodes of one chain.

    Returns (shapes, feasible).  Two-step solve:

    1. *Peak minimization* — binary-search style scan over candidate peak
       caps C (ascending): the smallest C whose per-task best latencies
       sum within ``d_rem``.
    2. *Tile compaction* under the fixed peak — greedily step tasks down
       to smaller DoP candidates, choosing at each step the task whose
       step-down costs the least extra latency per tile freed, while the
       chain still fits ``d_rem``.  (The peak stays optimal; total tile
       usage shrinks.)
    """
    dnn = [t for t in unassigned if not wf.tasks[t].is_sensor]
    sensors = [t for t in unassigned if wf.tasks[t].is_sensor]

    shapes: Dict[str, Tuple[int, float]] = {}
    budget = d_rem
    for s in sensors:
        l = model.bound(s, q, 0)
        shapes[s] = (0, l)
        budget -= l

    if not dnn:
        return shapes, budget >= 0

    # -- step 1: minimal feasible peak C --------------------------------
    caps = sorted({
        c for t in dnn for c in wf.tasks[t].dop_candidates() if c <= tile_cap
    })
    if not caps:
        caps = [tile_cap]
    chosen_cap = None
    for C in caps:
        total = 0.0
        ok = True
        for t in dnn:
            c, lat = _best_latency_under_cap(model, wf, t, C, q)
            if c is None:
                ok = False
                break
            total += lat
        if ok and total <= budget:
            chosen_cap = C
            break
    feasible = chosen_cap is not None
    if chosen_cap is None:
        chosen_cap = caps[-1]  # best effort: run at the largest cap

    # latency-minimal allocation under the chosen peak
    alloc: Dict[str, int] = {}
    lats: Dict[str, float] = {}
    for t in dnn:
        c, lat = _best_latency_under_cap(model, wf, t, chosen_cap, q)
        if c is None:  # smallest candidate exceeds even the largest cap
            c = min(wf.tasks[t].dop_candidates())
            lat = model.bound(t, q, c)
        alloc[t], lats[t] = c, lat

    # -- step 2: greedy tile compaction ----------------------------------
    if feasible:
        improved = True
        while improved:
            improved = False
            total = sum(lats.values())
            best: Optional[Tuple[float, str, int, float]] = None
            for t in dnn:
                cands = [c for c in wf.tasks[t].dop_candidates() if c < alloc[t]]
                if not cands:
                    continue
                c2 = max(cands)
                lat2 = model.bound(t, q, c2)
                if total - lats[t] + lat2 > budget:
                    continue
                cost = (lat2 - lats[t]) / max(alloc[t] - c2, 1)
                if best is None or cost < best[0]:
                    best = (cost, t, c2, lat2)
            if best is not None:
                _, t, c2, lat2 = best
                alloc[t], lats[t] = c2, lat2
                improved = True

    for t in dnn:
        shapes[t] = (alloc[t], lats[t])
    return shapes, feasible


def chain_priority(wf: Workflow, chain: Chain) -> Tuple:
    """Sort key: critical chains first, then total load descending, then
    tightest deadline (Alg. 1 line 2)."""
    load = sum(wf.tasks[n].mean_flops for n in chain.nodes)
    return (not chain.critical, chain.deadline_s, -load, chain.name)


def run_phase1(
    model: LatencyModel,
    wf: Workflow,
    q: float,
    tile_cap: Optional[int] = None,
) -> Phase1Result:
    """Algorithm 1 — Multi-Chain Slack Distribution."""
    cap = tile_cap if tile_cap is not None else model.hw.num_tiles
    shapes: Dict[str, Tuple[int, float]] = {}
    infeasible: List[str] = []

    for chain in sorted(wf.chains, key=lambda c: chain_priority(wf, c)):
        done = [n for n in chain.nodes if n in shapes]
        unassigned = [n for n in chain.nodes if n not in shapes]
        d_rem = chain.deadline_s - sum(shapes[n][1] for n in done)
        if not unassigned:
            if d_rem < 0:
                infeasible.append(chain.name)
            continue
        sub, feasible = solve_subchain(model, wf, unassigned, d_rem, q, cap)
        shapes.update(sub)
        if not feasible:
            infeasible.append(chain.name)

    # nodes not on any chain (none in the stock benchmark, but allowed):
    for name, task in wf.tasks.items():
        if name in shapes:
            continue
        if task.is_sensor:
            shapes[name] = (0, model.profiles[name].latency_bound(q, 0, 1.0))
        else:
            c = model.best_dop(task, q, cap)
            shapes[name] = (c, model.bound(name, q, c))

    # -- topological start offsets (Alg. 1 lines 10-14) ------------------
    start: Dict[str, float] = {}
    end: Dict[str, float] = {}
    for v in wf.topological_order():
        preds = wf.preds(v)
        start[v] = max((end[u] for u in preds), default=0.0)
        end[v] = start[v] + shapes[v][1]

    return Phase1Result(
        shapes=shapes, start_offsets=start, infeasible_chains=infeasible
    )
