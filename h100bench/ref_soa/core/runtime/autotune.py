"""Tile-budget autotuner: joint (quantile, DoP, partition-count) search.

The paper's headline resource result — up to ~32 % fewer tiles than
work-conserving baselines at the same service level — comes from
searching colocation and DoP *jointly* under the shared E2E deadlines,
not from walking one knob at a time.  The original portfolio compile
did the latter: a one-dimensional q-relaxation ladder at a fixed
partition count, keeping the most conservative deadline-feasible
quantile per mode.  This module replaces it with a joint search:

* **Quantile axis** — the q grid of Eq. (1) bounds (the paper's §V-B
  guideline: relax q under pressure, tail-composition headroom covers
  the difference).
* **Spatial axis** — candidate partition counts around the compiler's
  default (ADS-Tile's configurable isolation domains) and a sweep of
  *tile budgets* below the full chip (``GHACompiler.tile_budget``),
  which squeezes the per-task DoPs through the compiler's own
  compaction machinery.
* **Pruning** — candidate (q, partition) cells are discarded without
  compiling when even the latency-minimal DoP assignment cannot meet a
  chain deadline; the check runs on the cached
  :meth:`~h100bench.ref_soa.core.latency_model.LatencyModel.bound_ladder`.

Every surviving compile becomes a :class:`FrontierPoint` carrying the
tiles it reserves and its *predicted E2E miss probability* (an
analytic per-chain bound, see :func:`predict_miss`).  A mode's
:class:`ModeFrontier` exposes the Pareto-optimal subset — more tiles
never buys a worse predicted miss on the frontier by construction —
and :meth:`ModeFrontier.select` picks the cheapest point meeting a
target miss probability (or, with no target, the most conservative
feasible point, which reproduces the legacy q-ladder choice exactly
when the partition count is pinned).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...obs import metrics
from ..gha.compiler import GHACompiler
from ..gha.schedule import Schedule
from ..latency_model import LatencyModel
from ..workload import Workflow

__all__ = [
    "FrontierPoint",
    "ModeFrontier",
    "autotune_mode",
    "predict_miss",
    "clear_frontier_cache",
]

#: bisection bracket for the per-chain composed quantile q* — below
#: 0.5 a schedule is useless (misses most deadlines), above ~0.9999
#: the lognormal tails stop moving within float resolution
_Q_LO = 0.5
_Q_HI = 0.9999
_Q_ITERS = 40


@dataclasses.dataclass(frozen=True, eq=False)
class FrontierPoint:
    """One compiled operating point of a mode.

    ``tiles`` is what the schedule actually reserves
    (``Schedule.peak_tiles``); ``miss`` is the analytic upper bound on
    the E2E deadline-miss probability (:func:`predict_miss`);
    ``feasible`` mirrors the compiler's own flags (no Phase-I
    infeasible chain, no Phase-III deadline violation).
    """

    tiles: int
    miss: float
    q: float
    num_partitions: int
    budget: int
    feasible: bool
    schedule: Schedule

    def key(self) -> Tuple[int, float, float, int]:
        return (self.tiles, self.miss, self.q, self.num_partitions)


@dataclasses.dataclass
class ModeFrontier:
    """All operating points explored for one driving mode."""

    mode: str
    points: List[FrontierPoint]

    def feasible_points(self) -> List[FrontierPoint]:
        return [p for p in self.points if p.feasible]

    def partition_counts(self) -> Tuple[int, ...]:
        return tuple(sorted({p.num_partitions for p in self.points}))

    def pareto(self) -> List[FrontierPoint]:
        """Non-dominated feasible points, cheapest first.

        Sorted by tiles ascending; a point survives only if its
        predicted miss is strictly below every cheaper survivor's, so
        the returned frontier is monotone: more tiles never increases
        the predicted miss probability.
        """
        best = math.inf
        out: List[FrontierPoint] = []
        for p in sorted(self.feasible_points(), key=lambda p: (p.tiles, p.miss)):
            if p.miss < best - 1e-15:
                out.append(p)
                best = p.miss
        return out

    def select(
        self,
        target_miss: Optional[float] = None,
        num_partitions: Optional[int] = None,
    ) -> FrontierPoint:
        """Pick the operating point the portfolio should install.

        With ``target_miss`` set: the fewest-tiles feasible point whose
        predicted miss meets the target (ties prefer the higher
        quantile); if no point meets it, the lowest-miss feasible
        point.  With no target: the most conservative feasible point —
        highest quantile, then lowest predicted miss, then fewest
        tiles — which is exactly the schedule the legacy q-relaxation
        ladder kept.  When nothing is feasible the ladder's fallback
        applies: the lowest-quantile compile.  ``num_partitions``
        restricts the choice to one spatial configuration (hot-swap
        compatibility requires every mode of a portfolio to share it).
        """
        pts = [
            p
            for p in self.points
            if num_partitions is None or p.num_partitions == num_partitions
        ]
        if not pts:
            raise ValueError(
                f"{self.mode}: no frontier point at {num_partitions} partitions"
            )
        feas = [p for p in pts if p.feasible]
        if not feas:
            return min(pts, key=lambda p: (p.q, p.miss, p.tiles))
        if target_miss is None:
            q_max = max(p.q for p in feas)
            top = [p for p in feas if p.q == q_max]
            return min(top, key=lambda p: (p.miss, p.tiles))
        within = [p for p in feas if p.miss <= target_miss]
        if within:
            return min(within, key=lambda p: (p.tiles, -p.q, p.miss))
        return min(feas, key=lambda p: (p.miss, p.tiles))

    def select_within_tiles(
        self,
        max_tiles: int,
        target_miss: Optional[float] = None,
    ) -> Optional[FrontierPoint]:
        """Degraded-budget selection: the best operating point whose
        reservation fits ``max_tiles`` — what an online replanner swaps
        to when tiles die (``docs/degradation.md``).  Any partition
        count qualifies (the engine morphs partitions online), feasible
        points meeting ``target_miss`` win on fewest tiles, then
        feasible points on lowest predicted miss, then infeasible ones
        as a last resort.  ``None`` when nothing fits the budget."""
        pts = [p for p in self.points if p.tiles <= max_tiles]
        if not pts:
            return None
        feas = [p for p in pts if p.feasible]
        if not feas:
            return min(pts, key=lambda p: (p.miss, p.tiles, -p.q))
        if target_miss is not None:
            within = [p for p in feas if p.miss <= target_miss]
            if within:
                return min(within, key=lambda p: (p.tiles, -p.q, p.miss))
        return min(feas, key=lambda p: (p.miss, p.tiles, -p.q))

    def blend_source(
        self, num_partitions: int, selected: FrontierPoint
    ) -> Optional[FrontierPoint]:
        """The most conservative feasible point at ``num_partitions``
        if it is more conservative than ``selected`` — the transition
        hedge draws per-task plans from it so a budget-tightened
        portfolio still hedges with the high-quantile plan while the
        context is ambiguous.  ``None`` when ``selected`` is already
        the most conservative choice."""
        feas = [
            p
            for p in self.feasible_points()
            if p.num_partitions == num_partitions
        ]
        if not feas:
            return None
        best = min(feas, key=lambda p: (-p.q, p.miss, p.tiles))
        if best is selected or best.q <= selected.q:
            return None
        return best

    def meta(self, selected: FrontierPoint) -> Dict[str, object]:
        """The ``Schedule.meta["autotune"]`` payload for ``selected``."""
        return {
            "q": selected.q,
            "tiles": selected.tiles,
            "predicted_miss": selected.miss,
            "num_partitions": selected.num_partitions,
            "budget": selected.budget,
            "frontier": [
                (p.tiles, p.miss, p.q, p.num_partitions) for p in self.pareto()
            ],
        }


# ---------------------------------------------------------------------------
# predicted E2E miss probability
# ---------------------------------------------------------------------------
def _chain_miss(
    model: LatencyModel,
    wf: Workflow,
    nodes: Tuple[str, ...],
    dops: np.ndarray,
    deadline_s: float,
) -> float:
    """Analytic miss bound for one chain under fixed DoPs.

    Finds (by bisection) the largest composed quantile q* at which the
    sum of per-task q*-bounds still fits the deadline; since the tasks'
    variations are independent, all tasks land within their q* bounds
    with probability q*^n, so the chain misses with probability at most
    ``1 - q*^n``.  This deliberately ignores tail-composition headroom
    (the bound is conservative) but it is *monotone*: larger DoPs lower
    every bound, raise q*, and lower the predicted miss.
    """
    n = len(nodes)

    def total(q: float) -> float:
        return float(np.sum(model.bound_batch(nodes, q, dops)))

    if total(_Q_HI) <= deadline_s:
        q_star = _Q_HI
    elif total(_Q_LO) > deadline_s:
        return 1.0
    else:
        lo, hi = _Q_LO, _Q_HI
        for _ in range(_Q_ITERS):
            mid = 0.5 * (lo + hi)
            if total(mid) <= deadline_s:
                lo = mid
            else:
                hi = mid
        q_star = lo
    return 1.0 - q_star**n


def predict_miss(model: LatencyModel, wf: Workflow, schedule: Schedule) -> float:
    """Predicted E2E deadline-miss probability of ``schedule``.

    The per-chain analytic bounds (:func:`_chain_miss`) are averaged
    weighted by chain activation rate — a 30 Hz chain contributes three
    times the misses of a 10 Hz chain over any horizon — so the figure
    is comparable to a simulated per-completion violation rate.
    """
    num = 0.0
    den = 0.0
    for chain in wf.chains:
        dops = np.asarray(
            [
                schedule.plans[t].dop if t in schedule.plans else 1
                for t in chain.nodes
            ],
            dtype=np.float64,
        )
        rate = wf.task_rate_hz(chain.nodes[-1])
        num += rate * _chain_miss(model, wf, chain.nodes, dops, chain.deadline_s)
        den += rate
    return num / den if den > 0 else 0.0


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------
def _chain_feasible(
    model: LatencyModel, wf: Workflow, q: float, tile_cap: int
) -> bool:
    """Cheap necessary condition for a (q, budget) cell: every chain
    must fit its deadline even with each task at its latency-minimal
    DoP candidate under the cap.  Runs entirely on the cached
    ``bound_ladder`` — no compile.  Conservative in the safe direction:
    a cell this check rejects cannot produce a feasible schedule, while
    a cell it accepts may still fail in the compiler (shared-node
    budgets, Phase-III packing)."""
    for chain in wf.chains:
        total = 0.0
        for t in chain.nodes:
            task = wf.tasks[t]
            if task.is_sensor:
                total += model.bound(t, q, 0)
            else:
                cands = task.dop_candidates(tile_cap)
                total += min(model.bound_ladder(t, q, cands))
        if total > chain.deadline_s:
            return False
    return True


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
_FRONTIER_CACHE: "OrderedDict[tuple, ModeFrontier]" = OrderedDict()
_FRONTIER_CACHE_MAX = 64


def clear_frontier_cache() -> None:
    """Drop memoized mode frontiers (test isolation hook)."""
    _FRONTIER_CACHE.clear()


def _model_fingerprint(model: LatencyModel) -> tuple:
    """Value identity of a latency model: profiles are frozen
    dataclasses and the hardware model is frozen, so equal-valued
    models — e.g. rebuilt per test from the same spec — hash alike."""
    return (tuple(sorted(model.profiles.items())), model.hw)


def _compile_point(
    model: LatencyModel,
    wf: Workflow,
    compiler: GHACompiler,
    q: float,
    n_parts: Optional[int],
    budget: Optional[int],
    dop_prune: Optional[float] = None,
    warm_start: Optional[Dict[str, int]] = None,
) -> FrontierPoint:
    # None means "the compiler's own ceiling" — a caller-configured
    # GHACompiler.tile_budget stays authoritative for full compiles and
    # bounds every budget-swept point from above
    if budget is None:
        budget = compiler.tile_budget
    elif compiler.tile_budget is not None:
        budget = min(budget, compiler.tile_budget)
    sched = dataclasses.replace(
        compiler, q=q, num_partitions=n_parts, tile_budget=budget
    ).compile(model, wf, warm_start=warm_start)
    feasible = (
        not sched.meta["phase1_infeasible"]
        and not sched.meta["phase3_violations"]
    )
    if dop_prune is not None:
        # multi-version compilation set (§IV-D2): the runtime may only
        # resize among DoPs whose binaries this operating point ships
        sched.meta["task_dop_candidates"] = {
            t: model.pruned_candidates(wf.tasks[t], q, dop_prune)
            for t in sched.plans
        }
    return FrontierPoint(
        tiles=sched.peak_tiles,
        miss=predict_miss(model, wf, sched),
        q=q,
        num_partitions=len(sched.partitions),
        budget=sched.meta.get("tile_budget", sched.total_tiles),
        feasible=feasible,
        schedule=sched,
    )


def autotune_mode(
    model: LatencyModel,
    wf: Workflow,
    compiler: Optional[GHACompiler] = None,
    q_grid: Sequence[float] = (0.9, 0.8, 0.7, 0.6, 0.5),
    partition_grid: Optional[Sequence[Optional[int]]] = None,
    budget_fracs: Sequence[float] = (0.85, 0.7),
    stop_at_feasible: bool = False,
    mode_name: str = "",
    dop_prune: Optional[float] = None,
) -> ModeFrontier:
    """Sweep candidate tile budgets for one mode's (model, workflow).

    For every quantile in ``(compiler.q,) + q_grid`` (descending,
    deduplicated) and every partition count in ``partition_grid``
    (default: the compiler's own), a cell passes the bound-ladder
    prune, compiles at the full tile budget, and — when the compile is
    feasible — recompiles at each fraction of its own reserved peak in
    ``budget_fracs``, tracing how far the tile reservation compresses
    before feasibility breaks.  ``stop_at_feasible`` reproduces the
    legacy ladder's early exit (walk q down, stop at the first
    feasible cell) — the cheap path for callers that only want the
    conservative point.  Results are memoized on the *values* of every
    input, so rebuilding an identical stack does not recompile.
    """
    compiler = compiler or GHACompiler()
    if partition_grid is None:
        partition_grid = (compiler.num_partitions,)
    qs = [compiler.q]
    for q in sorted(q_grid, reverse=True):
        if q < compiler.q - 1e-12 and q not in qs:
            qs.append(q)
    grid = tuple(dict.fromkeys(partition_grid))

    cache_key = (
        mode_name,
        _model_fingerprint(model),
        wf.structural_signature,
        (compiler.q, compiler.num_partitions, compiler.phase2_weights,
         compiler.bind_physical, compiler.tile_budget),
        tuple(qs),
        grid,
        tuple(budget_fracs),
        stop_at_feasible,
        dop_prune,
    )
    cached = _FRONTIER_CACHE.get(cache_key)
    if cached is not None:
        _FRONTIER_CACHE.move_to_end(cache_key)
        return cached

    m = model.hw.num_tiles
    if compiler.tile_budget is not None:
        m = max(1, min(m, int(compiler.tile_budget)))
    points: List[FrontierPoint] = []
    seen: set = set()

    def add(p: FrontierPoint) -> None:
        if p.key() not in seen:
            seen.add(p.key())
            points.append(p)

    with metrics.phase("autotune_search"):
        for n_parts in grid:
            found_feasible = False
            compiled_qs: set = set()
            for q in qs:
                if not _chain_feasible(model, wf, q, m):
                    continue
                p = _compile_point(model, wf, compiler, q, n_parts, None, dop_prune)
                compiled_qs.add(q)
                add(p)
                if p.feasible:
                    found_feasible = True
                    # budget-shrunk recompiles of the same (q, n_parts)
                    # cell warm-start Phase II from the full-budget
                    # compile's final partitioning — the task set is
                    # identical and the basin is adjacent, so the
                    # chain-grouped init + greedy merge are skipped.
                    # Full-budget compiles stay cold: they must remain
                    # bitwise equal to the legacy ladder's.
                    warm = {t: pl.partition for t, pl in p.schedule.plans.items()}
                    for frac in budget_fracs:
                        budget = int(math.floor(p.tiles * frac))
                        if budget < len(p.schedule.partitions) or budget >= p.tiles:
                            continue
                        shrunk = _compile_point(
                            model,
                            wf,
                            compiler,
                            q,
                            n_parts,
                            budget,
                            dop_prune,
                            warm_start=warm,
                        )
                        if shrunk.feasible:
                            add(shrunk)
                    if stop_at_feasible:
                        break
            if not found_feasible and qs[-1] not in compiled_qs:
                # ladder fallback: no feasible cell and the lowest quantile
                # was pruned away — compile it anyway so the portfolio has
                # the same (flagged-infeasible) last-rung table to degrade
                # onto that the legacy ladder kept
                add(
                    _compile_point(
                        model, wf, compiler, qs[-1], n_parts, None, dop_prune
                    )
                )

    frontier = ModeFrontier(mode=mode_name, points=points)
    _FRONTIER_CACHE[cache_key] = frontier
    while len(_FRONTIER_CACHE) > _FRONTIER_CACHE_MAX:
        _FRONTIER_CACHE.popitem(last=False)
    return frontier
