"""Online replanning across driving modes (scenario subsystem runtime).

The offline GHA schedule is compiled against *one* latency model; when
the driving context shifts (urban -> downpour), every per-task budget
and partition capacity in that table is stale.  Recompiling GHA online
is far too slow for a mode switch, so the runtime keeps a *portfolio*
of per-mode schedules precomputed offline (one GHA compile per
registered mode, exactly like multi-version DoP compilation keeps
per-DoP binaries, §IV-D2) and hot-swaps on ``mode_change`` through the
engine's bounded-reallocation path — the swap stalls partitions and
charges migration volume like any other reallocation, so its cost shows
up in ``realloc_frac`` rather than being assumed free.

Any :class:`~repro_torch.core.sim.policy.Policy` can carry an
:class:`OnlineReplanner`: the base class's ``on_mode_change`` delegates
to ``policy.replanner`` when one is attached.

:class:`PredictiveReplanner` goes one step further: instead of paying
the swap exactly *at* the seam — the moment the new mode's load
arrives — it consumes :class:`~repro_torch.core.runtime.forecast.ModeForecast`s
and spends the bounded-realloc window *before* the seam.  A
high-confidence forecast **pre-swaps** the target mode's full table
``lead_s`` ahead of the predicted switch (weight/feature migration is
charged through the same bounded-realloc path, just earlier and under
the old, typically lighter, load); a low-confidence forecast installs a
**blended** table (:func:`blend_schedules`) that hedges per task
between the old and new plans by slack, deferring the capacity move to
the seam itself.  A forecast that never materialises is *reverted*, and
the revert is cheap by construction: PENDING jobs are retargeted, not
migrated, so swapping back charges no checkpoint bytes for work that
never ran under the staged table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, TYPE_CHECKING

from ...obs import metrics
from ..gha.compiler import GHACompiler
from ..gha.schedule import Schedule
from ..latency_model import LatencyModel
from ..sim.engine import ForecastStats
from ..workload import Workflow
from .autotune import FrontierPoint, ModeFrontier, autotune_mode
from .forecast import ModeForecast, ModeForecaster
from .reservation import most_urgent_plan

if TYPE_CHECKING:  # pragma: no cover
    from ..sim.engine import Simulator

__all__ = [
    "SchedulePortfolio", "OnlineReplanner", "PredictiveReplanner",
    "blend_schedules",
]


@dataclasses.dataclass
class SchedulePortfolio:
    """Per-mode precomputed GHA schedules, keyed by mode name.

    ``frontiers`` keeps each mode's full autotuner search
    (:class:`~.autotune.ModeFrontier`) and ``selected`` the operating
    point actually installed — the predictive replanner's blend tables
    draw alternative per-task plans from them (transition hedging
    co-optimizes the quantile with the plan, see :func:`blend_schedules`).
    """

    schedules: Dict[str, Schedule]
    frontiers: Dict[str, ModeFrontier] = dataclasses.field(default_factory=dict)
    selected: Dict[str, FrontierPoint] = dataclasses.field(default_factory=dict)

    def get(self, mode: str) -> Optional[Schedule]:
        return self.schedules.get(mode)

    def blend_alternative(
        self, mode: str, num_partitions: int
    ) -> Optional[Schedule]:
        """A more conservative same-partition-count frontier table for
        ``mode``, if the autotuner kept one beyond the installed point
        (None otherwise).  Transition blends hedge per task against it."""
        frontier = self.frontiers.get(mode)
        point = self.selected.get(mode)
        if frontier is None or point is None:
            return None
        alt = frontier.blend_source(num_partitions, point)
        return None if alt is None else alt.schedule

    @classmethod
    def compile(
        cls,
        model: LatencyModel,
        wf: Workflow,
        modes: Mapping[str, object],
        compiler: Optional[GHACompiler] = None,
        q_ladder: tuple = (0.9, 0.8, 0.7, 0.6, 0.5),
        target_miss: Optional[float] = None,
        partition_span: int = 1,
        budget_fracs: tuple = (0.85, 0.7),
        dop_prune: Optional[float] = None,
        harmonize_partitions: bool = True,
    ) -> "SchedulePortfolio":
        """Per-mode tile-budget autotuning (see :mod:`~.autotune`).

        ``modes`` maps mode name to any object exposing
        ``transform_model(model) -> LatencyModel`` (duck-typed so this
        module does not depend on the scenarios package; in practice a
        :class:`repro_torch.scenarios.DrivingMode`).  Modes that also expose
        ``transform_workflow(wf) -> Workflow`` (sensor-rate modulation)
        are compiled against their *own* workflow — and therefore their
        own hyper-period: Phase II's reservation windows, instance
        counts and per-partition capacities all follow the mode's
        sensor rates, so a hot-swap at a rate seam installs a table
        that actually matches the new release pattern.

        With no ``target_miss`` each mode keeps the most conservative
        deadline-feasible operating point — the walk down ``q_ladder``
        stops at the first feasible quantile, exactly the legacy
        q-relaxation behaviour (§V-B: relax q under pressure,
        tail-composition headroom covers the difference).

        With a ``target_miss``, the full joint search runs: quantiles
        × partition counts (``compiler.num_partitions ±
        partition_span``) × tile budgets (``budget_fracs`` of each
        feasible compile's own peak), and every mode installs the
        *cheapest* frontier point whose predicted E2E miss probability
        meets the target.

        ``harmonize_partitions`` (the legacy default) restricts the
        spatial axis to one common partition count across modes — the
        one minimizing the portfolio's total reserved tiles subject to
        every mode meeting the target.  This predates the engine's
        online partition morphing, which lets a hot-swap split/merge
        partitions at the seam; pass ``False`` to let every mode keep
        its *own* best partition count (morph stalls are charged
        through the same bounded-realloc path as any other swap).
        """
        with metrics.phase("portfolio_compile"):
            compiler = compiler or GHACompiler()
            explore = target_miss is not None
            base_p = compiler.num_partitions
            frontiers: Dict[str, ModeFrontier] = {}
            mode_wfs: Dict[str, Workflow] = {}
            for name, mode in modes.items():
                m_model = mode.transform_model(model)
                transform_wf = getattr(mode, "transform_workflow", None)
                m_wf = transform_wf(wf) if transform_wf is not None else wf
                if explore and base_p is not None and base_p > 1:
                    n_dnn = len(m_wf.dnn_tasks)
                    grid = tuple(dict.fromkeys(
                        max(2, min(p, n_dnn))
                        for p in range(base_p - partition_span,
                                       base_p + partition_span + 1)
                    ))
                else:
                    grid = (base_p,)
                frontiers[name] = autotune_mode(
                    m_model, m_wf, compiler,
                    q_grid=tuple(q_ladder),
                    partition_grid=grid,
                    budget_fracs=tuple(budget_fracs) if explore else (),
                    stop_at_feasible=not explore,
                    mode_name=name,
                    dop_prune=dop_prune,
                )
                mode_wfs[name] = m_wf

            # joint spatial harmonization (legacy): pin every mode to
            # one partition count.  With morphing (harmonize off) each
            # mode selects freely and the engine splits/merges online.
            p_star: Optional[int] = None
            if explore and harmonize_partitions:
                common = set.intersection(
                    *(set(f.partition_counts()) for f in frontiers.values())
                )
                if common:
                    def p_score(p: int) -> tuple:
                        sels = [f.select(target_miss, p) for f in frontiers.values()]
                        short = sum(
                            (not s.feasible) or s.miss > target_miss for s in sels
                        )
                        tiles = sum(s.tiles for s in sels)
                        anchor = abs(p - base_p) if base_p is not None else 0
                        return (short, tiles, anchor, p)
                    p_star = min(sorted(common), key=p_score)

            out: Dict[str, Schedule] = {}
            selected: Dict[str, FrontierPoint] = {}
            for name, frontier in frontiers.items():
                point = frontier.select(target_miss, p_star)
                m_wf = mode_wfs[name]
                sched = point.schedule
                sched.meta["mode"] = name
                sched.meta["hyper_period_s"] = m_wf.hyper_period_s
                # per-task activation periods under this mode's sensor
                # rates: the engine's rate-aware hot-swap re-staggers
                # PENDING ERTs onto the incoming regime's release grid
                # whenever these differ from the outgoing table's
                sched.meta["task_period_s"] = {
                    t: 1.0 / m_wf.task_rate_hz(t)
                    for t, task in m_wf.tasks.items() if not task.is_sensor
                }
                sched.meta["autotune"] = frontier.meta(point)
                out[name] = sched
                selected[name] = point
            return cls(out, frontiers=frontiers, selected=selected)


def blend_schedules(
    old: Schedule,
    new: Schedule,
    wf: Workflow,
    alt: Optional[Schedule] = None,
) -> Schedule:
    """Blend two scheduling tables for a low-confidence transition.

    Partition capacities stay the *old* table's — the expensive part of
    a swap is the capacity move (preempted jobs, checkpoint migration),
    and a transition we are not sure about must not pay it yet.  Plans
    blend **per task by slack**
    (:func:`~.reservation.most_urgent_plan`): each task adopts
    whichever regime's plan gives it the earlier sub-deadline — the
    more *urgent* of the targets — so the runtime treats every task at
    least as urgently as either regime demands while the context is
    ambiguous.  DoPs are clamped to the retained partition capacities.

    ``alt`` optionally adds a third per-task candidate: a more
    conservative frontier table of the target mode
    (:meth:`SchedulePortfolio.blend_alternative`).  A budget-tightened
    portfolio installs relaxed-quantile plans, but while the context is
    *ambiguous* the hedge may draw the high-quantile plan instead —
    the blend co-optimizes the quantile with the plan per task.

    The blend carries the old table's ``task_period_s`` meta: the
    sensor-rate regime has not changed yet, so a later full swap still
    sees the correct outgoing periods and re-staggers at the real seam.
    """
    if len(old.partitions) != len(new.partitions):
        raise ValueError("blend requires schedules with equal partition counts")
    if alt is not None and len(alt.partitions) != len(old.partitions):
        raise ValueError("blend alternative must match the partition count")
    caps = {p.index: p.capacity for p in old.partitions}
    plans = {}
    for task, new_plan in new.plans.items():
        # candidate order matters: earlier entries win slack ties, so
        # the old plan (fewest retargets) dominates, then the target
        # mode's installed plan, then the conservative alternative
        cands = [new_plan]
        old_plan = old.plans.get(task)
        if old_plan is not None:
            cands.insert(0, old_plan)
        if alt is not None and task in alt.plans:
            cands.append(alt.plans[task])
        pick = most_urgent_plan(cands, wf.deadline_offset(task))
        dop = max(1, min(pick.dop, caps[pick.partition]))
        plans[task] = dataclasses.replace(pick, dop=dop)
    meta: Dict[str, object] = {
        "blend_of": (old.meta.get("mode"), new.meta.get("mode")),
        "hyper_period_s": old.meta.get("hyper_period_s"),
    }
    if old.meta.get("task_period_s") is not None:
        meta["task_period_s"] = old.meta["task_period_s"]
    # multi-version DoP sets (§IV-D2): during a transition both
    # regimes' compiled versions are resident (the new table's were
    # pre-staged), so the blend's runtime ladder is the per-task union
    # — never the full workflow ladder, which would let FitQuota pick
    # versions neither table compiled
    cand_metas = [
        s.meta.get("task_dop_candidates")
        for s in ((old, new) + ((alt,) if alt is not None else ()))
    ]
    if any(c is not None for c in cand_metas):
        merged: Dict[str, tuple] = {}
        for task in plans:
            sets = [set(c[task]) for c in cand_metas if c and task in c]
            if sets:
                merged[task] = tuple(sorted(set.union(*sets)))
        meta["task_dop_candidates"] = merged
    return Schedule(
        plans=plans,
        partitions=[dataclasses.replace(p) for p in old.partitions],
        q=min(old.q, new.q),
        total_tiles=old.total_tiles,
        meta=meta,
    )


@dataclasses.dataclass
class OnlineReplanner:
    """Reacts to ``mode_change`` by hot-swapping the matching schedule.

    ``resetup`` re-runs ``policy.setup`` after a swap so schedule-derived
    policy state (e.g. ADS-Tile's downstream slack budgets) follows the
    new table.  Modes without a portfolio entry keep the current
    schedule (graceful degradation rather than a hard error — a fleet
    may meet contexts it never compiled for).
    """

    portfolio: SchedulePortfolio
    resetup: bool = True
    #: a real runtime cannot observe "the mode changed" as an event: it
    #: infers the context shift from sensor/latency statistics over a
    #: confirmation window (Liu et al. 2022).  ``detection_delay_s`` > 0
    #: models that window — the reactive swap fires this long *after*
    #: the seam, running the new load on the stale table meanwhile.
    #: The default 0 keeps the original oracle-reactive behaviour.
    detection_delay_s: float = 0.0
    n_swaps: int = 0
    total_stall_s: float = 0.0
    #: degraded-operation response (docs/degradation.md): on a tile
    #: fault the replanner drops to the cheapest frontier point that
    #: fits the surviving tiles (the L2P re-placement then maps the new
    #: table around the dead tiles); on recovery it restores the mode's
    #: own table.  Off, the policy rides the fault out on its shrunken
    #: partition.
    respond_to_faults: bool = True
    n_degrade_swaps: int = 0
    _fault_depth: int = dataclasses.field(default=0, repr=False)
    _fault_swapped: bool = dataclasses.field(default=False, repr=False)

    def _swap_to(
        self,
        sim: "Simulator",
        table: Optional[Schedule],
        regime_anchor_s: Optional[float] = None,
        prestage_window_s: float = 0.0,
    ) -> float:
        """Install ``table`` through the bounded-realloc hot-swap path
        (no-op when it is missing or already active)."""
        if table is None or table is sim.schedule:
            return 0.0
        stall = sim.hotswap_schedule(
            table,
            regime_anchor_s=regime_anchor_s,
            prestage_window_s=prestage_window_s,
        )
        self.total_stall_s += stall
        self.n_swaps += 1
        if self.resetup:
            sim.policy.setup(sim)
        return stall

    def _reactive_swap(self, sim: "Simulator", mode: str, now: float) -> None:
        """Swap to ``mode``'s table the way a reactive runtime can:
        immediately with an oracle (delay 0), else after the detection
        confirmation window.  The seam time (``now``) rides in the
        detect payload: the regime's sensor timers re-anchored at the
        *seam*, so the deferred swap must re-stagger straddling ERTs
        onto that grid — anchoring at the detection instant would admit
        them mid-frame, the exact failure the rate-aware re-stagger
        exists to prevent."""
        if self.detection_delay_s > 0.0:
            sim.arm_forecast(
                now + self.detection_delay_s, ("detect", mode, now)
            )
        else:
            self._swap_to(sim, self.portfolio.get(mode))

    def on_mode_change(self, sim: "Simulator", mode: str, now: float) -> None:
        self._reactive_swap(sim, mode, now)

    def on_degrade(self, sim: "Simulator", event: object, begin: bool) -> None:
        """Tile-fault response: re-plan against the reduced tile budget.

        On fault onset the engine has already shrunk (and possibly
        evacuated) the struck partition; this hook then swaps to the
        mode frontier's best operating point that *fits the surviving
        tiles* (:meth:`~.autotune.ModeFrontier.select_within_tiles`) —
        installing it lets the L2P indirection re-place the table
        around the dead tiles, so the new table runs at full nominal
        capacity.  If the installed table already fits, it is
        re-installed (a copy, forcing the re-placement swap).  When the
        last fault lifts, the mode's own table is restored.  Other
        degradation kinds need no spatial response: throttles and
        bandwidth loss are temporal, dropout storms act through the
        trace.
        """
        if not self.respond_to_faults or getattr(event, "kind", "") != "tile_fault":
            return
        mode = sim._mode_now
        if begin:
            self._fault_depth += 1
            avail = sim.hw.num_tiles - sim.fault_tiles_lost
            frontier = self.portfolio.frontiers.get(mode) if mode else None
            table = None
            if frontier is not None:
                point = frontier.select_within_tiles(avail)
                table = None if point is None else point.schedule
            if table is None:
                table = self.portfolio.get(mode)
                if table is not None and table.peak_tiles > avail:
                    table = None  # nothing fits: ride the fault out
            if table is None:
                return
            if table is sim.schedule:
                # same table, new placement: force the swap so the L2P
                # remap (and its honest stall) actually happens
                table = dataclasses.replace(table)
            self._swap_to(sim, table)
            self.n_degrade_swaps += 1
            self._fault_swapped = True
        else:
            self._fault_depth = max(0, self._fault_depth - 1)
            if self._fault_depth == 0 and self._fault_swapped:
                self._fault_swapped = False
                self._swap_to(sim, self.portfolio.get(mode))

    def on_forecast(self, sim: "Simulator", payload: object, now: float) -> None:
        """Deferred detection: the confirmation window armed at the
        seam has elapsed — swap to the (by now confirmed) mode,
        anchored at the seam recorded in the payload.  If the context
        shifted again meanwhile, that seam armed its own detection
        event which will re-correct; briefly installing the stale
        detection's table is exactly what a confirmation-window
        runtime does."""
        if (
            isinstance(payload, tuple)
            and len(payload) == 3
            and payload[0] == "detect"
        ):
            self._swap_to(
                sim, self.portfolio.get(payload[1]),
                regime_anchor_s=payload[2],
            )


@dataclasses.dataclass
class PredictiveReplanner(OnlineReplanner):
    """Forecast-driven replanning: pre-swap or blend *ahead* of seams.

    State machine per mode segment:

    1. On entering a mode (run start or ``mode_change``) the replanner
       asks the :class:`~.forecast.ModeForecaster` for the segment's
       end.  A forecast with confidence >= ``confidence_lo`` arms a
       *forecast* scheduling point ``lead_s`` before the predicted
       switch.
    2. When that point fires: confidence >= ``confidence_hi``
       **pre-stages** the target table
       (:meth:`~repro_torch.core.sim.engine.Simulator.prestage_schedule`) —
       its weight/feature deltas background-copy over the remaining
       lead window, charged through the bounded-realloc accounting but
       freezing nothing, while the active table keeps guiding the
       outgoing regime; a confidence in ``[lo, hi)`` installs the
       **blended** table (:func:`blend_schedules` — per-task urgency
       hedge, no capacity move).  A revert guard is armed
       ``revert_grace_s`` past the predicted switch.
    3. At the actual seam the target table is *activated* through the
       ordinary hot-swap: with a correct pre-stage its weights are
       already resident, so the seam stall shrinks to live-state
       preemptions (the part that can never be background-copied)
       instead of the full migration a reactive swap pays at the worst
       moment.  A wrong stage falls back to the reactive swap, having
       wasted only background traffic; a *pre-stage* whose seam never
       comes is reverted for free — the active table was never touched
       — while a blend revert swaps the hedged plans back through the
       ordinary bounded-realloc path (cheap, not free).

    Observed dwells feed back into the forecaster at every seam, and
    repeated reverts inside one segment exponentially damp re-staging
    (``revert_backoff``) so a bad forecaster degrades to reactive
    behaviour instead of thrashing.
    """

    forecaster: Optional[ModeForecaster] = None
    #: stage this many seconds before the predicted switch
    lead_s: float = 0.08
    #: confidence >= hi: full pre-swap; in [lo, hi): blend; < lo: reactive
    confidence_hi: float = 0.6
    confidence_lo: float = 0.25
    #: undo a stage this long after a predicted switch that never came
    revert_grace_s: float = 0.1
    #: per-revert confidence damping within one segment
    revert_backoff: float = 0.5
    #: drain-aware activation: after a correct forecast the staged
    #: table is activated as soon as no partition would have to preempt
    #: a running job (capacity shrinks wait for stragglers of the old
    #: mode to drain), forced at the latest this long past the seam.
    #: 0 activates at the seam unconditionally.  While waiting, the
    #: engine's drain watch re-checks at every partition ``finish``
    #: event — allocation only ever drops when a job finishes, so the
    #: swap lands at the exact drain instant instead of on a poll grid.
    max_drain_s: float = 0.08
    forecast_stats: ForecastStats = dataclasses.field(
        default_factory=ForecastStats
    )
    _cur_mode: Optional[str] = dataclasses.field(default=None, repr=False)
    _entered_at: float = dataclasses.field(default=0.0, repr=False)
    _staged: Optional[ModeForecast] = dataclasses.field(default=None, repr=False)
    _staged_blend: bool = dataclasses.field(default=False, repr=False)
    _staged_at: float = dataclasses.field(default=0.0, repr=False)
    _segment_reverts: int = dataclasses.field(default=0, repr=False)
    _epoch: int = dataclasses.field(default=0, repr=False)
    #: (mode, seam_s, deadline_s) of a drain-deferred activation
    _pending_act: Optional[tuple] = dataclasses.field(default=None, repr=False)

    # -- engine hooks ----------------------------------------------------
    def on_run_start(self, sim: "Simulator", mode: str, now: float) -> None:
        self._cur_mode = mode
        self._entered_at = now
        self._arm(sim, now)

    def on_mode_change(self, sim: "Simulator", mode: str, now: float) -> None:
        if self._cur_mode is not None and self.forecaster is not None:
            self.forecaster.observe_switch(
                self._cur_mode, mode, now - self._entered_at
            )
        staged = self._staged
        self._epoch += 1          # stale stage/revert/activate events die here
        if self._pending_act is not None:
            self._pending_act = None
            sim.clear_drain_watch()
        stats = self.forecast_stats
        if staged is None:
            self._reactive_swap(sim, mode, now)
        elif staged.target_mode == mode:
            # correct forecast: activate the pre-staged table (its
            # weight deltas are resident) or commit the blend's
            # deferred capacity move.  The forecast told the runtime
            # what to watch for, so the seam is a *confirmation*, not
            # an open-set detection — no detection delay.  Activation
            # is drain-aware: it fires the moment no partition would
            # preempt a straggler of the outgoing mode, bounded by
            # ``max_drain_s``; the swap anchors at the true seam so the
            # rate-aware ERT re-stagger is exact.
            stats.n_hits += 1
            stats.lead_s_total += max(0.0, now - self._staged_at)
            self._activate(sim, mode, now, seam_s=now,
                           deadline_s=now + self.max_drain_s)
        else:
            # wrong forecast: the runtime is watching for the wrong
            # transition and must detect this one like any reactive
            # system — the full confirmation window applies
            stats.n_misses += 1
            self._reactive_swap(sim, mode, now)
        self._staged = None
        self._staged_blend = False
        self._segment_reverts = 0
        self._cur_mode = mode
        self._entered_at = now
        self._arm(sim, now)

    def _reactive_swap(self, sim: "Simulator", mode: str, now: float) -> None:
        # unlike the base replanner — where every seam arms a detect
        # that supersedes the last — a predictive hit activates with no
        # follow-up event, so a stale detect from an earlier missed
        # seam would clobber the correct table and nothing would
        # re-correct it.  Epoch-tag detects so seams kill stale ones.
        # The seam time rides along as the regime anchor (see the base
        # class's _reactive_swap).
        if self.detection_delay_s > 0.0:
            sim.arm_forecast(
                now + self.detection_delay_s,
                ("detect", self._epoch, mode, now),
            )
        else:
            self._swap_to(sim, self.portfolio.get(mode))

    def on_forecast(self, sim: "Simulator", payload: object, now: float) -> None:
        if not isinstance(payload, tuple) or len(payload) < 2:
            return
        kind = payload[0]
        if kind == "detect":           # deferred miss/fallback detection
            if len(payload) == 4 and payload[1] == self._epoch:
                self._swap_to(
                    sim, self.portfolio.get(payload[2]),
                    regime_anchor_s=payload[3],
                )
            return
        epoch = payload[1]
        if epoch != self._epoch:
            return
        if kind == "stage":
            self._stage(sim, payload[2], now)
        elif kind == "revert":
            self._revert(sim, now)
        elif kind in ("activate", "drain"):
            # "drain": the engine's drain watch saw a partition free
            # allocation (a finish event) while an activation was
            # deferred; "activate": the max_drain_s force deadline
            if self._pending_act is not None:
                mode, seam_s, deadline_s = self._pending_act
                self._activate(sim, mode, now, seam_s, deadline_s)

    # -- internals -------------------------------------------------------
    def _arm(self, sim: "Simulator", now: float) -> None:
        if self.forecaster is None or self._cur_mode is None:
            return
        f = self.forecaster.forecast(self._cur_mode, self._entered_at, now)
        if f is None:
            return
        self.forecast_stats.n_forecasts += 1
        conf = f.confidence * (self.revert_backoff ** self._segment_reverts)
        if conf < self.confidence_lo or self.portfolio.get(f.target_mode) is None:
            return
        f = dataclasses.replace(f, confidence=conf)
        sim.arm_forecast(
            max(now, f.switch_at_s - self.lead_s), ("stage", self._epoch, f)
        )

    def _activate(
        self,
        sim: "Simulator",
        mode: str,
        now: float,
        seam_s: float,
        deadline_s: float,
    ) -> None:
        """Drain-aware activation of ``mode``'s table: swap as soon as
        no partition would preempt (every capacity shrink fits under
        the current allocation), forced at ``deadline_s``.

        While stragglers hold the over-capacity tiles the replanner
        arms the engine's *drain watch*: allocation can only drop at a
        job ``finish``, so the watch re-fires this check at exactly
        those instants and the swap lands at the true drain point.  A
        single ``activate`` forecast event at ``deadline_s`` bounds the
        wait (stragglers of a dying mode must not block the new table
        forever)."""
        table = self.portfolio.get(mode)
        if table is None or table is sim.schedule:
            self._pending_act = None
            sim.clear_drain_watch()
            return
        if now + 1e-12 < deadline_s:
            n_new = len(table.partitions)
            over = any(
                # partitions the swap would morph away must drain too
                (p.allocated > 0 if p.idx >= n_new
                 else table.partitions[p.idx].capacity < p.allocated)
                for p in sim.parts
            )
            if over:
                if self._pending_act is None:
                    # first deferral: arm the force deadline once; the
                    # per-finish re-checks ride the drain watch
                    sim.arm_forecast(deadline_s, ("activate", self._epoch))
                self._pending_act = (mode, seam_s, deadline_s)
                sim.arm_drain_watch(("drain", self._epoch))
                return
        self._pending_act = None
        sim.clear_drain_watch()
        self._swap_to(sim, table, regime_anchor_s=seam_s)

    def _stage(self, sim: "Simulator", f: ModeForecast, now: float) -> None:
        if self._staged is not None:
            return
        new = self.portfolio.get(f.target_mode)
        if new is None or new is sim.schedule:
            return
        stats = self.forecast_stats
        window = max(0.0, f.switch_at_s - now)
        morphing = len(new.partitions) != len(sim.schedule.partitions)
        if f.confidence >= self.confidence_hi or morphing:
            # a blend keeps the old partitions by construction, so a
            # cross-partition-count transition (unharmonized portfolio)
            # hedges by pre-staging instead
            # full pre-stage: background-copy the target table's
            # weight/feature deltas; the active table — and every
            # running/pending job — is untouched until the seam
            stats.n_preswaps += 1
            stats.prestage_bytes += sim.prestage_schedule(new, window)
            blend = False
        else:
            # low-confidence hedge: install the blended table (plan
            # urgency only, no capacity move); its few adopted-new-plan
            # weight deltas background-copy over the same window.  The
            # hedge draws a third per-task candidate from the target
            # mode's frontier (the most conservative feasible table at
            # this partition count) so a budget-tightened portfolio
            # still hedges with the high-quantile plan while the
            # context is ambiguous.
            stats.n_blends += 1
            alt = self.portfolio.blend_alternative(
                f.target_mode, len(sim.schedule.partitions)
            )
            stats.prestage_stall_s += self._swap_to(
                sim, blend_schedules(sim.schedule, new, sim.wf, alt=alt),
                prestage_window_s=window,
            )
            blend = True
        self._staged = f
        self._staged_blend = blend
        self._staged_at = now
        sim.arm_forecast(
            f.switch_at_s + self.revert_grace_s, ("revert", self._epoch)
        )

    def _revert(self, sim: "Simulator", now: float) -> None:
        if self._staged is None:
            return
        stats = self.forecast_stats
        if self._staged_blend:
            # undo the plan hedge: swap back to the current mode's own
            # table.  No capacity ever moved and PENDING jobs were only
            # retargeted (nothing charged for them), but the tasks the
            # hedge had moved onto new-regime plans pay their weight
            # deltas back through the ordinary bounded-realloc stall —
            # a blend miss is cheap, not free.
            self._swap_to(sim, self.portfolio.get(self._cur_mode))
        # a full pre-stage needs no undo at all: the active table was
        # never touched — the wrong forecast cost exactly the staged
        # background traffic, already charged
        stats.n_misses += 1
        stats.n_reverts += 1
        self._staged = None
        self._staged_blend = False
        self._segment_reverts += 1
        self._arm(sim, now)
