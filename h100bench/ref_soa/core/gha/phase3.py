"""GHA Phase III — Intra-partition Temporal Compaction (paper §III-B4).

Enforces the total tile budget ``sum_s |B_s| <= M``:

1. scale bin capacities proportionally:
   ``|B_s| <- floor(|B_s| * M / sum |B_s'|)`` (Fig. 5b);
2. repack tasks inside each bin with a first-fit-decreasing heuristic —
   sort by tie-broken priority (criticality, sub-deadline, size), place
   each at the earliest offset respecting precedence and bin capacity,
   reshaping (smaller DoP candidate + recomputed budget) any item wider
   than its shrunken bin;
3. iterate to compact gaps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from ..latency_model import LatencyModel
from ..workload import Workflow
from .phase1 import Phase1Result
from .phase2 import Phase2Result

__all__ = ["Phase3Result", "run_phase3"]


@dataclasses.dataclass
class Phase3Result:
    shapes: Dict[str, Tuple[int, float]]      # possibly reshaped (c_v, l_v)
    start_offsets: Dict[str, float]           # refined t_v
    capacities: List[int]                     # scaled |B_s|
    deadline_violations: List[str]            # chains whose plan now overruns


def _chain_end(wf: Workflow, chain, ends: Dict[str, float]) -> float:
    return ends[chain.nodes[-1]]


def _surplus(caps: List[int], floors: List[int]) -> int:
    return sum(max(0, c - f) for c, f in zip(caps, floors))


def _bin_floors(
    model: LatencyModel,
    wf: Workflow,
    p1: Phase1Result,
    p2: Phase2Result,
    q: float,
) -> List[int]:
    """Per-bin minimum capacity: (a) each member task must retain a DoP
    whose budget keeps every chain through it within deadline (other
    tasks held at their Phase-I budgets); (b) the bin must carry its
    members' sustained tile-seconds per hyper-period (mean-rate floor —
    a bin below it falls behind no matter how the runtime schedules)."""
    nbins = len(p2.capacities)
    floors = [1] * nbins
    for t, b in p2.assignment.items():
        task = wf.tasks[t]
        # slack available to t on its tightest chain
        tightest = float("inf")
        for ch in wf.chain_for(t):
            others = sum(
                p1.budget(n) for n in ch.nodes if n != t
            )
            tightest = min(tightest, ch.deadline_s - others)
        if tightest == float("inf"):
            tightest = p1.budget(t)
        c_need = None
        for c in task.dop_candidates():
            if model.bound(t, q, c) <= tightest:
                c_need = c
                break
        if c_need is None:
            c_need = min(task.dop_candidates())
        floors[b] = max(floors[b], c_need)

    # sustained-demand floor from the Phase-II windows
    windows = p2.windows
    thp = windows.hyper_period_s
    busy = [0.0] * nbins
    dops = {t: c for t, (c, _) in p1.shapes.items() if not wf.tasks[t].is_sensor}
    for act, d in zip(windows.active, windows.durations):
        for t, n in act.items():
            busy[p2.assignment[t]] += dops[t] * n * d
    for s in range(nbins):
        floors[s] = max(floors[s], int(math.ceil(1.1 * busy[s] / thp)))
    return floors


def run_phase3(
    model: LatencyModel,
    wf: Workflow,
    p1: Phase1Result,
    p2: Phase2Result,
    total_tiles: int,
    q: float,
    compaction_rounds: int = 3,
) -> Phase3Result:
    shapes = dict(p1.shapes)
    caps = list(p2.capacities)

    # -- 1. proportional capacity scaling ---------------------------------
    total = sum(caps)
    if total > total_tiles:
        caps = [max(1, int(c * total_tiles / total)) for c in caps]

    # -- feasibility repair: a bin must at least fit, for each member, the
    # smallest DoP that keeps the member's chains within deadline assuming
    # every *other* budget stays at its Phase-I value.  Fund starved bins
    # from bins holding surplus above their own floor. --------------------
    floors = _bin_floors(model, wf, p1, p2, q)
    deficit = [max(0, floors[s] - caps[s]) for s in range(len(caps))]
    for s in range(len(caps)):
        while deficit[s] > 0:
            donors = [
                d for d in range(len(caps))
                if d != s and caps[d] > floors[d]
            ]
            if not donors:
                break
            d = max(donors, key=lambda d: caps[d] - floors[d])
            caps[d] -= 1
            caps[s] += 1
            deficit[s] -= 1
    # never shrink below the largest *minimum* DoP candidate in the bin
    for s, cap in enumerate(caps):
        members = [t for t, b in p2.assignment.items() if b == s]
        if members:
            need = max(min(wf.tasks[t].dop_candidates()) for t in members)
            caps[s] = max(cap, need)

    # -- reshape items wider than their bin (Fig. 5b, task B2) ------------
    for t, b in p2.assignment.items():
        c, _ = shapes[t]
        if c > caps[b]:
            cands = [x for x in wf.tasks[t].dop_candidates() if x <= caps[b]]
            c2 = max(cands) if cands else min(wf.tasks[t].dop_candidates())
            shapes[t] = (c2, model.bound(t, q, c2))

    # -- 2-3. FFD repack with precedence, iterated -------------------------
    starts = dict(p1.start_offsets)
    for _ in range(compaction_rounds):
        starts = _ffd_repack(model, wf, shapes, p2.assignment, caps, starts)

    # recompute ends & check chain deadlines
    ends: Dict[str, float] = {}
    for v in wf.topological_order():
        ends[v] = starts[v] + shapes[v][1]
    violations = [
        ch.name for ch in wf.chains
        if _chain_end(wf, ch, ends) > ch.deadline_s + 1e-9
    ]

    return Phase3Result(
        shapes=shapes,
        start_offsets=starts,
        capacities=caps,
        deadline_violations=violations,
    )


def _ffd_repack(
    model: LatencyModel,
    wf: Workflow,
    shapes: Dict[str, Tuple[int, float]],
    assignment: Dict[str, int],
    caps: List[int],
    prev_starts: Dict[str, float],
) -> Dict[str, float]:
    """One FFD pass over all bins, respecting cross-bin precedence.

    Items are placed in topological order (so predecessor end times are
    known), tie-broken by (criticality, previous sub-deadline, -size) —
    the paper's 'deadline/criticality, then index' priority.
    """
    crit = {
        t: any(c.critical for c in wf.chain_for(t)) for t in wf.tasks
    }
    # topological placement order keeps predecessor ends known; among
    # topological peers, critical/tight-deadline items are visited first
    # (the paper's 'deadline/criticality, then index' tie-break).
    topo_rank = {t: i for i, t in enumerate(wf.topological_order())}
    order = sorted(
        (t for t in wf.tasks if not wf.tasks[t].is_sensor),
        key=lambda t: (
            topo_rank[t],
            not crit[t],
            prev_starts.get(t, 0.0) + shapes[t][1],
        ),
    )
    starts: Dict[str, float] = {}
    ends: Dict[str, float] = {}
    for s in wf.tasks:
        if wf.tasks[s].is_sensor:
            starts[s] = 0.0
            ends[s] = shapes[s][1]

    # per-bin placed intervals: list of (start, end, width)
    placed: Dict[int, List[Tuple[float, float, int]]] = {
        b: [] for b in range(len(caps))
    }

    def fits(b: int, t0: float, t1: float, width: int) -> bool:
        cap = caps[b]
        pts = sorted({t0, *(
            max(a, t0) for a, e, _ in placed[b] if t0 < e and a < t1
        )})
        for p in pts:
            used = sum(w for a, e, w in placed[b] if a <= p < e)
            if used + width > cap:
                return False
        return True

    for t in order:
        b = assignment[t]
        c, l = shapes[t]
        ready = max((ends[u] for u in wf.preds(t)), default=0.0)
        t0 = ready
        # earliest feasible offset: scan candidate starts (ready time and
        # ends of already-placed items)
        candidates = sorted(
            {t0, *(e for _, e, _ in placed[b] if e >= t0 - 1e-12)}
        )
        pos = None
        for cand in candidates:
            if fits(b, cand, cand + l, c):
                pos = cand
                break
        if pos is None:  # place after everything in the bin
            pos = max((e for _, e, _ in placed[b]), default=t0)
            pos = max(pos, t0)
        starts[t] = pos
        ends[t] = pos + l
        placed[b].append((pos, pos + l, c))

    return starts
