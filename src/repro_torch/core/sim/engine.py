"""Tile-stream event-driven simulation engine (paper §V-A).

Execution model
---------------
Each DNN *job* (one activation of a task) samples its workload ``W`` (F1)
and I/O latency ``I`` (F2) from the task's latency profile.  Run
start-to-finish at DoP ``c`` the job would take::

    T(c) = W / (c * P) + I + (c - 1) * sync_s

Progress is tracked as a fraction in [0, 1]; running at DoP ``c``
advances progress at rate ``1/T(c)``.  DoP changes and preemptions are
initiated at scheduling points; chunk boundaries (``n_chunks`` per job,
§IV-D2 operator chunks) generate additional scheduling points for
long-running jobs.  A reallocation stalls *the whole partition*
(stop-migrate-restart, §IV-D1); migration volume follows the L2P
minimal-move model (§IV-D3): ``per-tile checkpoint bytes x |c_new -
c_old|`` per resized job.

Accounting
----------
Per partition the engine integrates allocated-tile-seconds, split into
*effective* (running) and *realloc waste* (allocated but stalled).
Idle is everything else.  E2E chain latencies are measured from source
sample time to sink completion using the unrolled instance dependency
structure (§II-C2).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...obs import metrics
from ..gha.schedule import Schedule
from ..hardware import HardwareModel
from ..latency_model import LatencyModel
from ..workload import Workflow
from .policy import Policy
from .trace import Trace, build_skeleton, sample_trace

__all__ = [
    "DegradeStats", "ForecastStats", "Job", "JobState", "ModeStats",
    "SimConfig", "Simulator", "SimReport",
]


class JobState(enum.Enum):
    PENDING = 0   # waiting for data
    READY = 1     # data available, not running
    RUNNING = 2
    DONE = 3
    DROPPED = 4


#  - eq=False: identity hash, jobs live in ready sets
#  - slots=True: ~2x faster construction (the warm-build hot loop) and
#    faster field access everywhere in the event loop
@dataclasses.dataclass(eq=False, slots=True)
class Job:
    jid: int
    task: str
    cycle: int
    idx: int
    release: float                  # absolute source-sample time
    is_sensor: bool
    work_flops: float
    io_s: float
    sync_s: float
    partition: int                  # -1 for sensors
    ert: float                      # absolute earliest-ready-time (t_v)
    sub_ddl: float                  # absolute sub-deadline
    e2e_ddl: float                  # tightest E2E deadline through this task
    plan_dop: int                   # offline c_v
    deps_remaining: int = 0
    succs: Sequence[int] = ()       # skeleton-shared tuple; never mutated

    state: JobState = JobState.PENDING
    progress: float = 0.0
    dop: int = 0
    rate: float = 0.0               # progress per second (0 while stalled)
    last_t: float = 0.0
    gen: int = 0
    ready_t: float = math.nan
    start_t: float = math.nan
    finish_t: float = math.nan
    degraded: bool = False          # an upstream job was dropped
    n_resizes: int = 0
    drop_at_release: bool = False   # scenario sensor dropout window
    #: DoP -> total duration memo: policies re-evaluate the same few
    #: candidate durations at every scheduling point (event-loop fast
    #: path; work/io/sync are fixed once sampled).  Lazily created so
    #: job construction does not allocate a dict per job.
    _dur: Optional[Dict[int, float]] = dataclasses.field(
        default=None, repr=False
    )
    #: (candidate tuple, durations tuple) memo for the policies'
    #: candidate-ladder walks; see :meth:`duration_ladder`
    _ladder: Optional[tuple] = dataclasses.field(default=None, repr=False)
    #: ``(gen, target - projected_finish)`` memo for at-risk scans,
    #: with the finish projection anchored at ``last_t`` (``last_t +
    #: (1-progress)/rate``): for a job running steadily at one DoP the
    #: projection is constant, so the slack against its deadline target
    #: is too — one float per rate epoch (``gen`` changes whenever
    #: rate/DoP do).  Used by the batched fast lanes.
    _margin: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def duration(self, c: int, tile_flops: float) -> float:
        if self.is_sensor:
            return self.io_s  # sensor latency pre-sampled into io_s
        c = max(int(c), 1)
        memo = self._dur
        if memo is None:
            memo = self._dur = {}
        d = memo.get(c)
        if d is None:
            d = (
                self.work_flops / (c * tile_flops)
                + self.io_s
                + self.sync_s * (c - 1)
            )
            memo[c] = d
        return d

    def remaining(self, c: int, tile_flops: float) -> float:
        # duration() inlined: this runs per candidate at every
        # scheduling point and the extra call frame is measurable
        if self.is_sensor:
            return (1.0 - self.progress) * self.io_s
        c = max(int(c), 1)
        memo = self._dur
        if memo is None:
            memo = self._dur = {}
        d = memo.get(c)
        if d is None:
            d = (
                self.work_flops / (c * tile_flops)
                + self.io_s
                + self.sync_s * (c - 1)
            )
            memo[c] = d
        return (1.0 - self.progress) * d

    def duration_ladder(self, cands: tuple, tile_flops: float) -> tuple:
        """Durations for a whole DoP-candidate tuple, memoized on the
        tuple's identity.  Policies walk this ladder at every
        scheduling point (FitQuota, the EDF quota pass); per-candidate
        ``remaining()`` calls were the hottest line of a Monte-Carlo
        sweep.  Callers must pass the *same* tuple object per task
        (the policies' per-task candidate caches do)."""
        lad = self._ladder
        if lad is None or lad[0] is not cands:
            lad = self._ladder = (
                cands,
                tuple(self.duration(c, tile_flops) for c in cands),
            )
        return lad[1]


@dataclasses.dataclass(slots=True)
class _Partition:
    idx: int
    capacity: int
    running: Dict[int, int] = dataclasses.field(default_factory=dict)  # jid -> dop
    #: running total of sum(running.values()); maintained incrementally
    #: at every mutation of ``running`` (event-loop fast path —
    #: ``free``/``allocated`` are called at every scheduling point)
    alloc: int = 0
    stalled: bool = False
    stall_end: float = 0.0
    last_t: float = 0.0
    busy_ts: float = 0.0           # effective tile-seconds
    realloc_ts: float = 0.0        # stalled-but-allocated tile-seconds
    n_realloc: int = 0
    realloc_bytes: float = 0.0
    decision_ratios: List[float] = dataclasses.field(default_factory=list)

    @property
    def allocated(self) -> int:
        return self.alloc

    def free(self) -> int:
        return self.capacity - self.alloc


@dataclasses.dataclass
class SimConfig:
    duration_s: float = 2.0
    seed: int = 0
    n_chunks: int = 6
    drop_policy: str = "hard"       # "hard": drop at E2E ddl; "soft": never
    collect_latencies: bool = True
    #: §IV-D2 fidelity: chunks are unpreemptable, so a reallocation must
    #: wait for the longest in-flight chunk before migration starts.
    #: Off by default (continuous-progress approximation).
    chunk_boundary_realloc: bool = False
    #: optional ``repro_torch.scenarios.ScenarioScript`` (duck-typed so the
    #: engine stays independent of the scenarios package): jobs sample
    #: from the mode active at their release time, segment boundaries
    #: become ``mode_change`` events, and the report gains per-mode
    #: accounting.  Modes that modulate sensor *rates* change the
    #: hyper-period mid-run: the engine unrolls the DAG piecewise per
    #: rate regime (``scenario.rate_regimes``), re-anchoring the sensor
    #: timers at each seam while in-flight jobs of the old regime drain
    #: normally.  None reproduces the stationary single-profile run
    #: bit-for-bit.
    scenario: Optional[object] = None
    #: optional precomputed :class:`~repro_torch.core.sim.trace.Trace`: the
    #: sampled randomness for this (workflow, scenario, horizon, seed).
    #: When several policies simulate the *same* drive (paired
    #: Monte-Carlo comparisons) the caller samples once and shares the
    #: trace; ``None`` samples one internally.  The engine rejects a
    #: trace whose skeleton key does not match this run; the caller
    #: must also sample it from an equal latency model.
    trace: Optional[Trace] = None
    #: optional flight recorder (duck-typed
    #: :class:`~repro_torch.obs.events.TraceRecorder` so the engine stays
    #: independent of the obs package): every hook site is one
    #: ``if rec is not None`` check, so a recorder-less run executes
    #: the same arithmetic as before the hooks existed and pinned-seed
    #: reports stay bit-identical (pinned by ``tests/test_obs.py``).
    recorder: Optional[object] = None


@dataclasses.dataclass
class ModeStats:
    """Per-driving-mode slice of a scenario run.

    Chain completions are attributed to the mode active at their
    *source sample time*; tile-second accounting is split exactly at
    ``mode_change`` boundaries (the engine touches every partition when
    the mode switches).
    """

    mode: str
    span_s: float                   # wall time spent in this mode
    n_completed: int                # chain sink completions
    n_violations: int
    p99_s: float                    # E2E p99 over chains in this mode
    effective_frac: float           # of tiles * span_s
    realloc_frac: float

    @property
    def violation_rate(self) -> float:
        return self.n_violations / self.n_completed if self.n_completed else 0.0


@dataclasses.dataclass
class ForecastStats:
    """Pre-stage accounting for predictive replanning.

    Filled by a :class:`~repro_torch.core.runtime.replan.PredictiveReplanner`
    (the engine copies the replanner's counters into the report).  A
    *pre-swap* installs the forecast target's full table ahead of the
    predicted seam; a *blend* installs the low-confidence hedge (old
    partitions, per-task plan choice by slack).  Hits/misses score the
    stage against the seam that actually arrived; ``prestage_stall_s``
    is the swap stall charged *ahead* of seams (it still lands in
    ``realloc_frac`` — pre-staging moves the cost, it does not hide it),
    and ``lead_s_total`` sums the realized seam-minus-stage lead.
    """

    n_forecasts: int = 0
    n_preswaps: int = 0
    n_blends: int = 0
    n_hits: int = 0
    n_misses: int = 0
    n_reverts: int = 0             # wrong stage undone before any seam
    prestage_bytes: float = 0.0    # background-staged weight/feature volume
    prestage_stall_s: float = 0.0
    lead_s_total: float = 0.0

    @property
    def hit_rate(self) -> float:
        staged = self.n_hits + self.n_misses
        return self.n_hits / staged if staged else 0.0


@dataclasses.dataclass
class DegradeStats:
    """Per-degradation-event accounting (docs/degradation.md).

    A window opens when its event begins and closes at *recovery*: the
    first on-time chain completion at/after the platform effect lifts
    (``t_end``).  ``misses_during`` counts every chain violation —
    late, degraded or dropped sinks — between onset and recovery, so a
    fault whose damage outlives the fault itself is charged honestly.
    ``recover_s`` is NaN when the run never recovers inside the
    horizon (permanent faults recover only if the runtime re-plans
    around them).
    """

    kind: str
    t_start: float
    t_end: float                   # when the platform effect lifts
    misses_during: int = 0
    completions_during: int = 0
    recover_s: float = math.nan    # first on-time completion - t_end


@dataclasses.dataclass
class SimReport:
    duration_s: float
    total_tiles: int
    # capacity decomposition (fractions of total processing power)
    effective_frac: float
    realloc_frac: float
    idle_frac: float
    dropped_work_frac: float
    # events
    n_realloc: int
    realloc_bytes: float
    n_jobs: int
    n_dropped: int
    task_miss_rate: float
    # per-chain
    chain_count: Dict[str, int]
    chain_violations: Dict[str, int]
    chain_p99_s: Dict[str, float]
    chain_latencies: Dict[str, List[float]]
    decision_ratios: List[float]
    # scenario runs only: per-mode accounting + switch count
    mode_stats: Dict[str, ModeStats] = dataclasses.field(default_factory=dict)
    n_mode_switches: int = 0
    # predictive replanning only: pre-stage accounting
    forecast: Optional[ForecastStats] = None
    #: tiles the run actually reserved: the maximum ``peak_tiles`` over
    #: every scheduling table active during the run (one table for a
    #: pinned run; the max across hot-swapped per-mode tables
    #: otherwise).  ``total_tiles`` is what the hardware *has*; the gap
    #: is the tile-budget autotuner's headline (figS_budget).
    tiles_used: int = 0
    #: time-weighted mean of the active table's ``peak_tiles`` — what
    #: the scheduler held *on average* over the run.  Per-mode tables
    #: reserve different tile counts, so a drive spending most of its
    #: time in light modes averages well below its peak reservation;
    #: a work-conserving single-bin table holds its full reservation
    #: for the whole drive by construction.
    tiles_reserved_mean: float = 0.0
    #: the initial table's autotuner metadata (``meta["autotune"]``):
    #: selected quantile/budget/predicted miss + the mode's Pareto
    #: frontier of (tiles, miss, q, partitions).  Empty for schedules
    #: compiled outside the autotuner.
    frontier_meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: deadline-miss attribution summary
    #: (:func:`~repro_torch.obs.attribution.attribution_report`); filled by
    #: the scenario runner for recorded runs, ``None`` otherwise
    attribution: Optional[Dict[str, object]] = None
    #: degraded-operation runs only: one :class:`DegradeStats` per
    #: injected event, in onset order.  Empty for degradation-free
    #: scenarios (and excluded from the report digest, so pre-existing
    #: pinned digests are unaffected).
    degrade: List[DegradeStats] = dataclasses.field(default_factory=list)

    @property
    def violation_rate(self) -> float:
        tot = sum(self.chain_count.values())
        return sum(self.chain_violations.values()) / tot if tot else 0.0

    def group_p99(self, critical: Dict[str, bool], want_critical: bool) -> float:
        lats: List[float] = []
        for ch, ls in self.chain_latencies.items():
            if critical.get(ch, False) == want_critical:
                lats.extend(ls)
        if not lats:
            return float("nan")
        return float(np.percentile(np.asarray(lats), 99))


class Simulator:
    """Event-driven Tile-stream simulator."""

    def __init__(
        self,
        wf: Workflow,
        model: LatencyModel,
        schedule: Schedule,
        policy: Policy,
        config: Optional[SimConfig] = None,
    ):
        self.wf = wf
        self.model = model
        self.schedule = schedule
        self.policy = policy
        self.cfg = config or SimConfig()
        if self.cfg.duration_s <= 0:
            raise ValueError("SimConfig.duration_s must be > 0")
        # flight recorder (None in production runs: every hook below is
        # a single ``is not None`` check on this local)
        self._rec = self.cfg.recorder
        self.hw: HardwareModel = model.hw

        self.now = 0.0
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._seq = 0
        self._end_t = self.cfg.duration_s
        # chunk-boundary event gating (fast path), two tiers:
        #  - policies that never act on "chunk" points (Cyc.,
        #    Tp-driven declare uses_chunk_points=False): skipping is
        #    behaviour-identical — those events were pure heap traffic;
        #  - jobs whose task compiles to a single DoP: their boundaries
        #    are skipped even under chunk-using policies.  This one is
        #    an intentional approximation — such a job's boundary was
        #    still a partition-wide scheduling point that could resize
        #    *co-located* jobs between other events.  The bundled
        #    workloads compile no single-DoP task, so stock benchmarks
        #    are unaffected.
        self._chunk_points = (
            bool(getattr(policy, "uses_chunk_points", True))
            and self.cfg.n_chunks > 1
        )
        self._fixed_dop: frozenset = frozenset(
            name for name, t in wf.tasks.items()
            if not t.is_sensor and len(t.dop_candidates()) <= 1
        )

        self.jobs: List[Job] = []
        self.parts: List[_Partition] = [
            _Partition(idx=p.index, capacity=p.capacity)
            for p in schedule.partitions
        ]
        # weight/feature state already staged in the background by a
        # predictive pre-stage: task -> (partition, dop) resident plans
        self._staged_plans: Dict[str, Tuple[int, int]] = {}
        # tile-reservation accounting + autotuner metadata for the report
        self._tiles_used: int = schedule.peak_tiles
        self._reserved_ts: float = 0.0   # peak_tiles-seconds of past tables
        self._reserved_t0: float = 0.0   # when the active table was installed
        self._frontier_meta: Dict[str, object] = dict(
            schedule.meta.get("autotune") or {}
        )
        # drain watch: an opaque payload re-delivered to the policy's
        # on_forecast at every job finish while armed (the predictive
        # replanner's drain-aware activation rides this — allocation
        # only drops at finishes, so polling between them is pointless)
        self._drain_watch: Optional[object] = None
        # scenario state: active mode + per-mode accounting buckets
        self._mode_now: Optional[str] = None
        self._mode_busy: Dict[str, float] = {}
        self._mode_realloc: Dict[str, float] = {}
        self._mode_lats: Dict[str, List[float]] = {}
        # (chain, mode) -> [completions, violations]
        self._sink_by_mode: Dict[Tuple[str, str], List[int]] = {}
        self.n_mode_switches = 0
        # degraded-operation state: injected platform events (duck-typed
        # from scenario.degradations), their per-event accounting, and
        # windows still awaiting recovery.  All empty for
        # degradation-free scenarios — every hook below is a cheap
        # truthiness check, so such runs stay bit-identical.
        scen0 = self.cfg.scenario
        self._degrades: tuple = tuple(
            getattr(scen0, "degradations", ()) or ()
        )
        self._degrade_stats: List[DegradeStats] = []
        self._deg_open: List[DegradeStats] = []
        self._bw_scale: float = 1.0
        #: all in-effect tile faults: event index -> dead tiles.  The
        #: L2P indirection can *re-place* a freshly installed table
        #: around dead tiles (a hot-swap whose table reserves no more
        #: than the surviving tiles absorbs the loss), so a fault is
        #: split into "active" (tiles physically dead) and "applied"
        #: (the loss currently lands on a partition's capacity).
        self._fault_active: Dict[int, int] = {}
        #: tiles currently lost to *applied* faults, per partition index
        self._fault_by_part: Dict[int, int] = {}
        #: per applied event: (partition index, k) so the end event
        #: restores exactly what it took
        self._fault_applied: Dict[int, Tuple[int, int]] = {}
        #: partitions retired by an online morph; kept for tile-second
        #: accounting (the report sums over live + retired)
        self._retired_parts: List[_Partition] = []
        self._build_jobs()
        self.chain_latencies: Dict[str, List[float]] = {
            c.name: [] for c in wf.chains
        }
        self.chain_violations: Dict[str, int] = {c.name: 0 for c in wf.chains}
        self.chain_count: Dict[str, int] = {c.name: 0 for c in wf.chains}
        self.dropped_work_ts = 0.0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _build_jobs(self) -> None:
        """Materialize the job list from the (cached) structural
        skeleton and the (vectorized) sampled trace.

        The piecewise per-rate-regime unrolling, dependency wiring and
        chain-source mapping live in
        :func:`~repro_torch.core.sim.trace.build_skeleton`; the per-job
        random draws follow the counter-based stream contract of
        :mod:`~repro_torch.core.sim.trace`.  This pass only binds the
        schedule's plans (partition, ERT, sub-deadline, planned DoP) to
        each job — the one input that differs between policies
        simulating the same drive.
        """
        wf, cfg = self.wf, self.cfg
        scen = cfg.scenario
        skel = build_skeleton(wf, scen, cfg.duration_s)
        self._regimes = skel.regimes
        trace = cfg.trace
        if trace is None:
            trace = sample_trace(skel, self.model, scen, cfg.seed)
        elif trace.skeleton_key != skel.key:
            raise ValueError(
                "SimConfig.trace was sampled for a different "
                "workflow/scenario/horizon than this run"
            )

        # per-task constants, hoisted out of the per-job loop.  The
        # mode transforms never touch sync_per_tile_s, so the base
        # profile's value is authoritative for every mode.
        plan_of: Dict[str, tuple] = {}
        for name, task in wf.tasks.items():
            ddl = wf.deadline_offset(name)
            if task.is_sensor:
                plan_of[name] = (True, ddl, None)
            else:
                plan = self.schedule.plans[name]
                plan_of[name] = (
                    False, ddl,
                    (
                        plan.partition, plan.ert_s, plan.subdeadline_s,
                        plan.dop, self.model.profiles[name].sync_per_tile_s,
                    ),
                )

        work_l = trace.work.tolist()
        io_l = trace.io.tolist()
        slat_l = trace.sensor_lat.tolist()
        # dropout-storm verdicts (STREAM_DEGRADE draws) fold into the
        # same drop-at-release seam as scenario dropout windows
        drops = skel.drop_at_release
        if getattr(trace, "storm_drop", None) is not None:
            drops = [a or bool(b) for a, b in zip(drops, trace.storm_drop)]
        append = self.jobs.append
        # positional Job construction in dataclass field order (jid,
        # task, cycle, idx, release, is_sensor, work_flops, io_s,
        # sync_s, partition, ert, sub_ddl, e2e_ddl, plan_dop,
        # deps_remaining, succs) — this loop runs once per job and
        # dominates warm build time, so it stays lean
        for i, (t, cyc, ix, rel_t, sen, dep, suc) in enumerate(zip(
            skel.tasks, skel.cycle, skel.idx, skel.release_list,
            skel.is_sensor, skel.deps_remaining, skel.succs,
        )):
            is_sensor, ddl, plan = plan_of[t]
            if is_sensor:
                lat = slat_l[i]
                append(Job(
                    i, t, cyc, ix, rel_t, True, 0.0, lat, 0.0, -1,
                    rel_t, rel_t + lat * 2, rel_t + ddl, 0, dep, suc,
                    drop_at_release=drops[i],
                ))
            else:
                part, ert_s, sub_s, dop, sync = plan
                append(Job(
                    i, t, cyc, ix, rel_t, False, work_l[i], io_l[i],
                    sync, part, rel_t + ert_s, rel_t + sub_s,
                    rel_t + ddl, dop, dep, suc,
                ))

        # chain accounting: (chain name, sink jid) -> absolute source
        # sample time, valid across regime seams (skeleton-shared,
        # read-only)
        self._sink_src: Dict[Tuple[str, int], float] = skel.sink_src

    # ------------------------------------------------------------------
    # event queue
    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload: tuple) -> None:
        if t > self._end_t:
            # the main loop stops at the horizon; events strictly past
            # it are never processed, so skip the heap traffic
            return
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    # ------------------------------------------------------------------
    # partition accounting
    # ------------------------------------------------------------------
    def _touch(self, part: _Partition) -> None:
        dt = self.now - part.last_t
        if dt > 0:
            alloc = part.allocated
            if part.stalled:
                part.realloc_ts += alloc * dt
                if self._mode_now is not None:
                    self._mode_realloc[self._mode_now] = (
                        self._mode_realloc.get(self._mode_now, 0.0) + alloc * dt
                    )
            else:
                part.busy_ts += alloc * dt
                if self._mode_now is not None:
                    self._mode_busy[self._mode_now] = (
                        self._mode_busy.get(self._mode_now, 0.0) + alloc * dt
                    )
        part.last_t = self.now

    def _advance_job(self, job: Job) -> None:
        dt = self.now - job.last_t
        if dt > 0 and job.rate > 0:
            job.progress = min(1.0, job.progress + dt * job.rate)
        job.last_t = self.now

    # ------------------------------------------------------------------
    # policy verbs
    # ------------------------------------------------------------------
    def free_tiles(self, partition: int) -> int:
        return self.parts[partition].free()

    def eligible_jobs(
        self, partition: int, admitted_only: bool = True
    ) -> List[Job]:
        """READY jobs of the partition, optionally filtered by ERT
        admission control (§IV-B2)."""
        out = []
        for job in self._ready_sets[partition]:
            if admitted_only and self.now + 1e-12 < job.ert:
                continue
            out.append(job)
        return out

    def start_job(self, job: Job, dop: int) -> None:
        part = self.parts[job.partition]
        assert job.state == JobState.READY, (job.task, job.state)
        assert dop <= part.free(), (
            f"{job.task}: dop {dop} > free {part.free()} in partition {part.idx}"
        )
        self._touch(part)
        self._ready_sets[job.partition].pop(job, None)
        job.state = JobState.RUNNING
        job.start_t = self.now
        job.dop = dop
        job.last_t = self.now
        part.running[job.jid] = dop
        part.alloc += dop
        if self._rec is not None:
            self._rec.emit(
                self.now, "job_start", jid=job.jid, task=job.task,
                partition=job.partition, value=dop,
            )
        if part.stalled:
            job.rate = 0.0  # will start when the stall ends
        else:
            self._set_rate(job)

    def _set_rate(self, job: Job) -> None:
        job.gen += 1
        t_total = job.duration(job.dop, self.hw.tile_flops)
        job.rate = 1.0 / max(t_total, 1e-9)
        rem = (1.0 - job.progress) / job.rate
        self._push(self.now + rem, "finish", (job.jid, job.gen))
        # next chunk boundary
        if not self._chunk_points or job.task in self._fixed_dop:
            return
        n = self.cfg.n_chunks
        nxt = math.floor(job.progress * n + 1e-9) + 1
        if nxt < n:
            dt = (nxt / n - job.progress) / job.rate
            self._push(self.now + dt, "chunk", (job.jid, job.gen))

    def resize(
        self,
        partition: int,
        new_dops: Dict[int, int],
        starts: Optional[Dict[int, int]] = None,
    ) -> float:
        """Apply a reallocation in one partition: resize running jobs per
        ``new_dops`` (jid -> dop) and start READY jobs per ``starts``.

        Returns the stall duration.  The whole partition stalls while
        checkpoints migrate (§IV-D1); migration volume uses the L2P
        minimal-move model.  If nothing actually changes for running
        jobs, new jobs start with zero stall.
        """
        part = self.parts[partition]
        starts = starts or {}
        changed = {
            jid: d for jid, d in new_dops.items()
            if jid in part.running and part.running[jid] != d
        }
        if not changed:
            for jid, d in starts.items():
                self.start_job(self.jobs[jid], d)
            return 0.0

        self._touch(part)
        moved = 0.0
        for jid, d in changed.items():
            job = self.jobs[jid]
            per_tile = self.wf.tasks[job.task].checkpoint_bytes
            old = part.running[jid]
            moved += per_tile * (old if d == 0 else abs(d - old))
            job.n_resizes += 1
        stall = self._realloc_stall(moved, part.capacity)
        if self.cfg.chunk_boundary_realloc:
            # §IV-D2: chunks are unpreemptable — migration waits for the
            # in-flight chunks of the *resized* jobs to drain (checkpoint
            # positions exist only at chunk boundaries)
            n = self.cfg.n_chunks
            drain = 0.0
            for jid in changed:
                job = self.jobs[jid]
                if job.rate <= 0 or jid not in part.running:
                    continue
                self._advance_job(job)
                frac = (job.progress * n) % 1.0
                drain = max(drain, (1.0 - frac) / (n * job.rate))
            stall += drain
        # freeze all running jobs (whole-partition stall, §IV-D1)
        for jid in part.running:
            job = self.jobs[jid]
            self._advance_job(job)
            job.rate = 0.0
            job.gen += 1
        # apply new dops now (tiles occupied during the stall);
        # dop == 0 preempts back to the ready queue
        shrunk = False
        rec = self._rec
        for jid, d in changed.items():
            job = self.jobs[jid]
            old = part.running[jid]
            if d == 0:
                part.alloc -= part.running.pop(jid)
                job.dop = 0
                job.state = JobState.READY
                self._ready_sets[partition][job] = None
                shrunk = True
            else:
                shrunk = shrunk or d < old
                part.alloc += d - old
                part.running[jid] = d
                job.dop = d
            if rec is not None:
                rec.emit(
                    self.now, "job_resize", jid=jid, task=job.task,
                    partition=partition, value=d, data={"old": old},
                )
        if rec is not None:
            rec.emit(
                self.now, "realloc", partition=partition, value=moved,
                data={"stall_s": stall, "n_resized": len(changed)},
            )
        if shrunk:
            self._notify_drain()
        self._begin_stall(part, moved, stall)
        for jid, d in starts.items():
            self.start_job(self.jobs[jid], d)
        return stall

    def _realloc_stall(self, moved: float, tiles: int) -> float:
        """Stop-migrate-restart stall for ``moved`` checkpoint bytes in
        a ``tiles``-tile partition, with any active ``bandwidth_loss``
        degradation stretching the migration (bytes / bandwidth) term.
        The fixed decision/hop overheads are NoC-control traffic and do
        not scale.  ``_bw_scale`` is exactly 1.0 outside degradation
        windows, so degradation-free runs take the untouched
        single-call path and stay bit-identical."""
        if self._bw_scale >= 1.0:
            return self.hw.realloc_latency(moved, tiles)
        base = self.hw.realloc_latency(0.0, tiles)
        full = self.hw.realloc_latency(moved, tiles)
        return base + (full - base) / max(self._bw_scale, 1e-9)

    def _begin_stall(self, part: _Partition, moved: float, stall: float) -> None:
        """Charge one stop-migrate-restart stall on ``part`` — shared by
        DoP resizes and schedule hot-swaps so both reallocation paths
        account identically (events, bytes, decision/migration ratio,
        resume arming)."""
        part.n_realloc += 1
        part.realloc_bytes += moved
        # decision/migration split: clamp migration time to >= 0 and skip
        # degenerate samples (tiny migrations would otherwise produce
        # nonsense ratios)
        mig = max(stall - self.hw.realloc.decision_s, 0.0)
        if mig > 1e-12:
            part.decision_ratios.append(self.hw.realloc.decision_s / mig)
        part.stalled = True
        part.stall_end = max(part.stall_end, self.now + stall)
        self._push(part.stall_end, "resume", (part.idx,))
        if self._rec is not None:
            self._rec.emit(
                self.now, "stall_begin", partition=part.idx, value=stall,
                data={"bytes": moved},
            )
            self._rec.stall_begin(part.idx, self.now)

    def _plan_deltas(self, new: Schedule):
        """Weight/feature stage-in volume per plan of ``new`` that is
        not already resident, in deterministic (sorted-task) order:
        yields ``(task, plan, bytes)``.  A partition move stages the
        full ``checkpoint_bytes x dop``; staying put costs the L2P
        minimal ``checkpoint_bytes x |dop delta|``.  Shared by
        :meth:`prestage_schedule` and :meth:`hotswap_schedule` so
        background and at-seam staging can never diverge."""
        for task in sorted(new.plans):
            plan = new.plans[task]
            if self._staged_plans.get(task) == (plan.partition, plan.dop):
                continue
            old_plan = self.schedule.plans.get(task)
            if old_plan is None or old_plan.partition != plan.partition:
                delta = plan.dop
            else:
                delta = abs(plan.dop - old_plan.dop)
            if delta:
                yield task, plan, self.wf.tasks[task].checkpoint_bytes * delta

    def prestage_schedule(self, new: Schedule, window_s: float) -> float:
        """Background-stage ``new``'s weight/feature state ahead of a
        forecast seam *without* touching the active table.

        For every task whose plan under ``new`` differs from the
        current table, the stage-in volume (``checkpoint_bytes x dop``
        on a partition move, the L2P minimal ``checkpoint_bytes x
        |dop delta|`` otherwise) is copied in the background: the next
        table's state is not live, so the copy is double-buffered and
        freezes nothing.  ``window_s`` is the forecast lead — each
        target partition stages whole tasks greedily until
        ``window_s x migration_bw`` is spent; the residue simply pays
        the ordinary stall at activation time.  Staged bytes are charged
        to ``realloc_bytes`` (the traffic is real, and a wrong forecast
        wastes it honestly), but no partition stalls, no job is touched,
        and no stall event is counted.

        A later :meth:`hotswap_schedule` that installs matching plans
        skips the staged volume — activation at the seam then stalls
        only for live-state preemptions.  Any hot-swap clears the staged
        set (the buffers are overwritten by the installed table).

        Returns the number of bytes staged.
        """
        budget = (
            max(0.0, window_s) * self.hw.realloc.migration_bw * self._bw_scale
        )
        spent: Dict[int, float] = {}
        total = 0.0
        for task, plan, volume in list(self._plan_deltas(new)):
            if spent.get(plan.partition, 0.0) + volume > budget:
                continue
            spent[plan.partition] = spent.get(plan.partition, 0.0) + volume
            self.parts[plan.partition].realloc_bytes += volume
            self._staged_plans[task] = (plan.partition, plan.dop)
            total += volume
        if self._rec is not None:
            self._rec.emit(
                self.now, "prestage", value=total,
                data={
                    "window_s": window_s,
                    "per_partition": {p: b for p, b in sorted(spent.items())},
                },
            )
        return total

    def hotswap_schedule(
        self,
        new: Schedule,
        regime_anchor_s: Optional[float] = None,
        prestage_window_s: float = 0.0,
    ) -> float:
        """Online replanning: swap the active scheduling table (the
        ``mode_change`` reaction of the runtime, §IV-C applied across
        contexts).

        Running jobs keep their tiles; if a partition's capacity shrank
        below its current allocation, running jobs are preempted back to
        the ready queue (largest allocation first) until it fits, and
        their checkpoints count as migration volume.  Every partition
        pays a stop-migrate-restart stall through the same bounded
        reallocation cost model as a DoP resize, so hot-swap cost lands
        in ``realloc_frac`` honestly.  PENDING/READY jobs are retargeted
        to the new plans (partition, ERT, sub-deadline, plan DoP).

        A table swap also *stages weights and features*: every task
        whose plan moved to another partition re-loads its per-tile
        state there (``checkpoint_bytes x plan dop``), and a task that
        stays put but changes planned DoP pays the L2P minimal move
        (``checkpoint_bytes x |dop delta|``).  The volume is charged to
        the task's *target* partition through the same bounded-realloc
        stall as everything else — this is the millisecond-scale cost a
        reactive swap pays exactly when the new mode's load arrives.
        Swapping to a table with identical plans stages nothing.

        ``prestage_window_s`` is the lead a *predictive* swap has before
        its regime actually starts: weight/feature stage-in that fits in
        ``window x migration_bw`` per partition is copied in the
        background (double-buffered — the next table's state is not
        live, so the copy needs no stop-the-world) and contributes **no
        stall**, while the bytes still land in ``realloc_bytes``.  The
        residual volume, and every live-state checkpoint of a preempted
        job (which can never be background-copied), stalls the
        partition as usual.  A reactive swap has no lead: window 0, the
        full volume freezes the partition at the seam.

        The retarget is *rate-aware*: when the incoming table records
        per-task periods (``meta["task_period_s"]``, portfolio compiles
        do) and a task's period differs from the outgoing regime's, the
        *straddling* PENDING jobs of that task — released on the old
        cadence (before ``regime_anchor_s``) but admitted after it —
        re-stagger their ERTs onto the new regime's release grid:
        ``anchor + k * period`` for the smallest ``k`` at/after the
        legacy ``release + plan.ert_s``.  Their old-grid releases would
        otherwise admit them mid-frame of the new cadence, exactly
        where the new table's reservation windows assume no entry.
        Jobs released at/after the anchor already sit on the new grid
        (the piecewise unroll re-anchors sensor timers at the seam) and
        keep the legacy offset, as do READY jobs (they hold data;
        delaying them to the next grid tick would starve admitted
        work).  ``regime_anchor_s`` is where the new regime's timers
        (re-)anchor: the seam itself for a reactive swap (default:
        now), the *forecast* seam for a predictive pre-swap.

        When ``new`` carries a *different partition count* the swap
        first **morphs** the partition set online (split/merge):
        surviving partitions keep their tiles and running jobs; removed
        partitions are retired — their running jobs are preempted and
        their live checkpoints carried to the partitions their tasks
        re-plan into (charged as migration volume there); newly created
        partitions start empty.  Retired partitions keep their
        tile-second accounting in the final report.  This removes the
        old same-partition-count restriction, so per-mode tables no
        longer need a harmonized spatial layout
        (``SchedulePortfolio.compile(harmonize_partitions=False)``).

        Returns the summed stall time across partitions.
        """
        carry: Dict[int, float] = {}
        if len(new.partitions) != len(self.parts):
            carry = self._morph_partitions(new)
        # L2P re-placement around dead tiles: a freshly installed table
        # whose reservation fits the *surviving* tiles maps its logical
        # tiles onto healthy physical ones, absorbing active faults
        # (the fault's end event then finds nothing left to restore).
        # A table that needs more keeps the per-partition loss.
        dead = sum(self._fault_active.values())
        if self._fault_applied and new.peak_tiles <= self.hw.num_tiles - dead:
            self._fault_applied.clear()
            self._fault_by_part.clear()
        elif self._fault_applied:
            # re-attribute losses whose partition was morphed away
            n_now = len(self.parts)
            for fdi, (pi, k) in list(self._fault_applied.items()):
                if pi >= n_now:
                    self._fault_by_part[pi] = self._fault_by_part.get(pi, k) - k
                    if self._fault_by_part.get(pi, 0) <= 0:
                        self._fault_by_part.pop(pi, None)
                    pj = pi % n_now
                    self._fault_applied[fdi] = (pj, k)
                    self._fault_by_part[pj] = self._fault_by_part.get(pj, 0) + k
        self._tiles_used = max(self._tiles_used, new.peak_tiles)
        self._reserved_ts += self.schedule.peak_tiles * max(
            0.0, self.now - self._reserved_t0
        )
        self._reserved_t0 = self.now
        # weight/feature staging volume per target partition (plan
        # deltas); state already background-staged for exactly this
        # (partition, dop) is resident and moves nothing
        staged: Dict[int, float] = {}
        for _task, plan, volume in self._plan_deltas(new):
            staged[plan.partition] = staged.get(plan.partition, 0.0) + volume
        # background-copy budget per partition: stage-in volume that the
        # pre-stage window can overlap with execution (never live state)
        bg_budget = (
            max(0.0, prestage_window_s)
            * self.hw.realloc.migration_bw
            * self._bw_scale
        )
        total_stall = 0.0
        for part in self.parts:
            new_cap = new.partitions[part.idx].capacity
            lost = self._fault_by_part.get(part.idx, 0)
            if lost:
                # active tile faults survive the swap: the new table's
                # nominal capacity is reduced by whatever is still dead
                new_cap = max(1, new_cap - lost)
            self._touch(part)
            stage_in = staged.get(part.idx, 0.0)
            overlapped = min(stage_in, bg_budget)
            moved = stage_in - overlapped   # residual: stalls the partition
            moved += carry.get(part.idx, 0.0)  # live state from retired parts
            if part.allocated > new_cap:
                victims = sorted(part.running, key=lambda j: (part.running[j], j))
                while part.allocated > new_cap and victims:
                    jid = victims.pop()  # largest allocation first
                    job = self.jobs[jid]
                    moved += (
                        self.wf.tasks[job.task].checkpoint_bytes
                        * part.running[jid]
                    )
                    self._advance_job(job)
                    if self._rec is not None:
                        self._rec.emit(
                            self.now, "job_preempt", jid=jid, task=job.task,
                            partition=part.idx, value=part.running[jid],
                            info="hotswap_shrink",
                        )
                    part.alloc -= part.running.pop(jid)
                    job.rate = 0.0
                    job.gen += 1
                    job.dop = 0
                    job.n_resizes += 1
                    job.state = JobState.READY
                    self._ready_sets[part.idx][job] = None
            part.capacity = new_cap
            stall = self._realloc_stall(moved, max(new_cap, 1))
            # freeze whatever keeps running for the swap stall (§IV-D1)
            for jid in part.running:
                frozen = self.jobs[jid]
                self._advance_job(frozen)
                frozen.rate = 0.0
                frozen.gen += 1
            # background-copied bytes are still reallocation traffic —
            # they count, they just do not freeze the partition
            self._begin_stall(part, moved + overlapped, stall)
            total_stall += stall

        # rate-aware ERT re-stagger: tasks whose period changed between
        # the outgoing and incoming tables snap PENDING ERTs onto the
        # new regime's release grid (anchored at the seam)
        anchor = self.now if regime_anchor_s is None else regime_anchor_s
        new_periods = new.meta.get("task_period_s") or {}
        old_periods = self.schedule.meta.get("task_period_s") or {}
        restagger: Dict[str, float] = {}
        for task, p_new in new_periods.items():
            p_old = old_periods.get(task)
            if p_old is None:
                t = self.wf.tasks.get(task)
                if t is None or t.is_sensor:
                    continue
                p_old = 1.0 / self.wf.task_rate_hz(task)
            if p_new > 0 and not math.isclose(p_new, p_old, rel_tol=1e-9):
                restagger[task] = p_new

        # retarget future jobs to the new plans
        for job in self.jobs:
            if job.is_sensor or job.state not in (JobState.PENDING, JobState.READY):
                continue
            plan = new.plans.get(job.task)
            if plan is None:
                continue
            if job.state == JobState.READY and plan.partition != job.partition:
                self._ready_sets[job.partition].pop(job, None)
                self._ready_sets[plan.partition][job] = None
            job.partition = plan.partition
            ert = job.release + plan.ert_s
            period = restagger.get(job.task)
            if (
                period is not None
                and job.state == JobState.PENDING
                and job.release < anchor - 1e-12
                and ert > anchor + 1e-12
            ):
                ert = anchor + math.ceil((ert - anchor) / period - 1e-9) * period
            job.ert = ert
            job.sub_ddl = job.release + plan.subdeadline_s
            job.plan_dop = plan.dop
            if job.state == JobState.READY and job.ert > self.now:
                self._push(job.ert, "ert", (job.jid,))
        self.schedule = new
        # the installed table's state overwrites the staging buffers
        self._staged_plans.clear()
        if self._rec is not None:
            self._rec.emit(
                self.now, "hotswap", value=total_stall,
                info=str(new.meta.get("mode", "")),
                data={
                    "peak_tiles": new.peak_tiles,
                    "prestage_window_s": prestage_window_s,
                },
            )
        return total_stall

    def _morph_partitions(self, new: Schedule) -> Dict[int, float]:
        """Online split/merge of the partition set to match ``new``.

        Shrinking retires the trailing partitions: every job running
        there is preempted (progress preserved) and parked READY in the
        partition its task re-plans into under ``new``; its live
        checkpoint bytes are *carried* — returned per target partition
        so :meth:`hotswap_schedule` charges them into that partition's
        swap stall (live state can never be background-staged).
        Growing appends empty partitions; capacities for every
        surviving partition are set by the caller's per-partition loop.
        Retired partitions stop accounting at the morph instant and are
        kept on ``_retired_parts`` so the report's tile-second and
        reallocation sums stay complete.
        """
        old_n, new_n = len(self.parts), len(new.partitions)
        rec = self._rec
        carry: Dict[int, float] = {}
        parked: List[Tuple[Job, float]] = []
        if new_n < old_n:
            for part in self.parts[new_n:]:
                self._touch(part)
                for jid in sorted(part.running):
                    job = self.jobs[jid]
                    held = part.running[jid]
                    self._advance_job(job)
                    if rec is not None:
                        rec.emit(
                            self.now, "job_preempt", jid=jid, task=job.task,
                            partition=part.idx, value=held,
                            info="morph_retire",
                        )
                    part.alloc -= part.running.pop(jid)
                    job.rate = 0.0
                    job.gen += 1
                    job.dop = 0
                    job.n_resizes += 1
                    job.state = JobState.READY
                    parked.append(
                        (job, self.wf.tasks[job.task].checkpoint_bytes * held)
                    )
                part.stalled = False  # pending "resume" events are moot
                self._retired_parts.append(part)
            for rs in self._ready_sets[new_n:]:
                parked.extend((j, 0.0) for j in rs)
            del self.parts[new_n:]
            del self._ready_sets[new_n:]
        else:
            for i in range(old_n, new_n):
                self.parts.append(_Partition(
                    idx=i,
                    capacity=new.partitions[i].capacity,
                    last_t=self.now,
                ))
                self._ready_sets.append({})
        # re-home displaced READY jobs onto their new-plan partitions
        # (the caller's retarget pass then fixes ERT/sub-deadline/DoP)
        for job, moved in parked:
            plan = new.plans.get(job.task)
            tgt = plan.partition if plan is not None else 0
            job.partition = tgt
            self._ready_sets[tgt][job] = None
            if moved:
                carry[tgt] = carry.get(tgt, 0.0) + moved
        if rec is not None:
            rec.emit(
                self.now, "morph", value=float(new_n),
                data={
                    "old_partitions": old_n,
                    "new_partitions": new_n,
                    "displaced": len(parked),
                },
            )
        return carry

    # ------------------------------------------------------------------
    # degraded operation (docs/degradation.md)
    # ------------------------------------------------------------------
    @property
    def fault_tiles_lost(self) -> int:
        """Tiles currently dead across all active tile faults (what a
        replanner must budget around: the surviving chip is
        ``hw.num_tiles - fault_tiles_lost``)."""
        return sum(self._fault_active.values())

    def _on_degrade(self, di: int, begin: bool) -> None:
        """Apply/lift one injected platform event (``degrade`` events
        seeded by :meth:`_prime` from ``scenario.degradations``)."""
        d = self._degrades[di]
        kind = getattr(d, "kind", type(d).__name__)
        scen = self.cfg.scenario
        rec = self._rec
        if begin:
            st = DegradeStats(
                kind=kind, t_start=self.now, t_end=d.end_s(self._end_t),
            )
            self._degrade_stats.append(st)
            self._deg_open.append(st)
            if kind == "tile_fault":
                self._apply_tile_fault(di, d)
            elif kind == "bandwidth_loss":
                self._bw_scale = scen.bandwidth_scale(self.now)
        else:
            if kind == "tile_fault":
                self._end_tile_fault(di)
            elif kind == "bandwidth_loss":
                # windows are half-open: at the end instant the lifted
                # event no longer contributes
                self._bw_scale = scen.bandwidth_scale(self.now)
        if rec is not None:
            rec.emit(
                self.now, "degrade_begin" if begin else "degrade_end",
                info=kind, value=float(di),
            )
        self.policy.on_degrade(self, d, begin)

    def _apply_tile_fault(self, di: int, d) -> None:
        """Tiles die: shrink the partition's capacity and, if the
        survivors no longer fit, evacuate running jobs (largest
        allocation first) through a stop-migrate-restart stall — their
        checkpoints must come off the dead tiles."""
        pi = d.partition % len(self.parts)
        part = self.parts[pi]
        self._touch(part)
        self._fault_active[di] = d.k_tiles
        self._fault_by_part[pi] = self._fault_by_part.get(pi, 0) + d.k_tiles
        self._fault_applied[di] = (pi, d.k_tiles)
        new_cap = max(
            1,
            self.schedule.partitions[pi].capacity
            - self._fault_by_part[pi],
        ) if pi < len(self.schedule.partitions) else max(
            1, part.capacity - d.k_tiles
        )
        moved = 0.0
        evacuated = False
        if part.allocated > new_cap:
            victims = sorted(part.running, key=lambda j: (part.running[j], j))
            while part.allocated > new_cap and victims:
                jid = victims.pop()  # largest allocation first
                job = self.jobs[jid]
                moved += (
                    self.wf.tasks[job.task].checkpoint_bytes
                    * part.running[jid]
                )
                self._advance_job(job)
                if self._rec is not None:
                    self._rec.emit(
                        self.now, "job_preempt", jid=jid, task=job.task,
                        partition=pi, value=part.running[jid],
                        info="tile_fault",
                    )
                part.alloc -= part.running.pop(jid)
                job.rate = 0.0
                job.gen += 1
                job.dop = 0
                job.n_resizes += 1
                job.state = JobState.READY
                self._ready_sets[pi][job] = None
                evacuated = True
        part.capacity = new_cap
        if evacuated:
            stall = self._realloc_stall(moved, max(new_cap, 1))
            for jid in part.running:
                frozen = self.jobs[jid]
                self._advance_job(frozen)
                frozen.rate = 0.0
                frozen.gen += 1
            self._begin_stall(part, moved, stall)
            self._notify_drain()

    def _end_tile_fault(self, di: int) -> None:
        """Dead tiles come back: restore capacity and give the policy a
        scheduling point to use them."""
        self._fault_active.pop(di, None)
        applied = self._fault_applied.pop(di, None)
        if applied is None:
            return  # absorbed by an L2P re-placement meanwhile
        pi, k = applied
        left = self._fault_by_part.get(pi, 0) - k
        if left > 0:
            self._fault_by_part[pi] = left
        else:
            self._fault_by_part.pop(pi, None)
        if pi >= len(self.parts):
            return  # the partition was morphed away meanwhile
        part = self.parts[pi]
        self._touch(part)
        part.capacity = max(
            1,
            self.schedule.partitions[pi].capacity - max(left, 0),
        ) if pi < len(self.schedule.partitions) else part.capacity + k
        self.policy.on_point(self, pi, self.now, "resume", None)

    def _deg_note(self, violated: bool) -> None:
        """Fold one chain-sink outcome into every open degradation
        window: violations count as misses-during; the first on-time
        completion at/after a window's effect lifts closes it and
        stamps its time-to-recover."""
        now = self.now
        closed = False
        for st in self._deg_open:
            st.completions_during += 1
            if violated:
                st.misses_during += 1
            elif now >= st.t_end - 1e-12:
                st.recover_s = max(0.0, now - st.t_end)
                closed = True
        if closed:
            self._deg_open = [
                st for st in self._deg_open if math.isnan(st.recover_s)
            ]

    def preempt(self, job: Job) -> None:
        """Remove a running job from its tiles back to the ready queue
        (progress preserved; used by work-conserving baselines)."""
        part = self.parts[job.partition]
        assert job.state == JobState.RUNNING
        self._touch(part)
        self._advance_job(job)
        job.rate = 0.0
        job.gen += 1
        job.dop = 0
        freed = part.running.pop(job.jid)
        part.alloc -= freed
        job.state = JobState.READY
        self._ready_sets[job.partition][job] = None
        if self._rec is not None:
            self._rec.emit(
                self.now, "job_preempt", jid=job.jid, task=job.task,
                partition=job.partition, value=freed,
            )
        self._notify_drain()

    def terminate(self, job: Job, reason: str = "deadline") -> None:
        """Drop a job (Cyc. budget overrun / E2E-deadline dequeue)."""
        part = self.parts[job.partition] if job.partition >= 0 else None
        freed = 0
        if job.state == JobState.RUNNING and part is not None:
            self._touch(part)
            self._advance_job(job)
            freed = part.running.pop(job.jid)
            part.alloc -= freed
            self._notify_drain()
        elif job.state == JobState.READY:
            self._ready_sets[job.partition].pop(job, None)
        if self._rec is not None:
            self._rec.emit(
                self.now, "job_drop", jid=job.jid, task=job.task,
                partition=job.partition, value=freed, info=reason,
            )
        job.state = JobState.DROPPED
        job.finish_t = self.now
        job.rate = 0.0
        job.gen += 1
        # account dropped processing power (remaining work at plan DoP);
        # sensors run on the SPE, not on tiles, so they carry none
        if not job.is_sensor:
            rem = job.remaining(max(job.plan_dop, 1), self.hw.tile_flops)
            self.dropped_work_ts += rem * max(job.plan_dop, 1)
        self._propagate(job)
        self._record_dropped_sink(job)
        self.policy.on_point(self, job.partition, self.now, "drop", job)

    def arm_timer(self, partition: int, t: float, job: Optional[Job] = None) -> None:
        self._push(t, "timer", (partition, job.jid if job else -1))

    def arm_forecast(self, t: float, payload: object = None) -> None:
        """Arm a *forecast* scheduling point at ``t``: the engine calls
        ``policy.on_forecast(sim, payload, now)`` when it fires (used by
        the predictive replanner to wake up ahead of a predicted seam).
        ``payload`` is opaque to the engine."""
        if self._rec is not None:
            self._rec.emit(self.now, "forecast_arm", value=t)
        self._push(t, "forecast", (payload,))

    def arm_drain_watch(self, payload: object) -> None:
        """Arm (or re-arm) the drain watch: until cleared, every event
        that drops a partition's allocation — a job finish, a resize
        that shrinks or preempts, a preemption, a drop — re-delivers
        ``payload`` to ``policy.on_forecast`` at that instant, so a
        drain-deferred schedule activation lands at the exact drain
        point instead of on a poll grid.  Finishes deliver inline
        (before the policy can refill the freed tiles); drops from
        within a policy pass are delivered as a same-timestamp event so
        the pass is never re-entered mid-flight."""
        if self._drain_watch is None and self._rec is not None:
            self._rec.emit(self.now, "drain_arm")
        self._drain_watch = payload

    def clear_drain_watch(self) -> None:
        if self._drain_watch is not None and self._rec is not None:
            self._rec.emit(self.now, "drain_clear")
        self._drain_watch = None

    def _notify_drain(self) -> None:
        """Queue a drain-watch delivery at the current instant (fired
        after the in-flight event completes, before time advances)."""
        if self._drain_watch is not None:
            self._push(self.now, "forecast", (self._drain_watch,))

    # ------------------------------------------------------------------
    # dependency propagation
    # ------------------------------------------------------------------
    def _propagate(self, job: Job) -> None:
        for sid in job.succs:
            succ = self.jobs[sid]
            if job.state == JobState.DROPPED or job.degraded:
                succ.degraded = True
            succ.deps_remaining -= 1
            if succ.deps_remaining == 0 and succ.state == JobState.PENDING:
                succ.state = JobState.READY
                succ.ready_t = self.now
                if succ.is_sensor:
                    continue
                self._ready_sets[succ.partition][succ] = None
                if self._rec is not None:
                    self._rec.emit(
                        self.now, "job_ready", jid=succ.jid, task=succ.task,
                        partition=succ.partition,
                    )
                self._push(self.now, "ready", (succ.jid,))
                if succ.ert > self.now:
                    self._push(succ.ert, "ert", (succ.jid,))

    def _finish_job(self, job: Job) -> None:
        part = self.parts[job.partition] if job.partition >= 0 else None
        freed = 0
        if part is not None and job.jid in part.running:
            self._touch(part)
            freed = part.running.pop(job.jid)
            part.alloc -= freed
        job.state = JobState.DONE
        job.progress = 1.0
        job.finish_t = self.now
        job.rate = 0.0
        job.gen += 1
        frec = self._rec
        if frec is not None:
            frec.emit(
                self.now, "job_finish", jid=job.jid, task=job.task,
                partition=job.partition, value=freed,
            )
        self._propagate(job)
        # chain accounting at sinks
        for chain in self.wf.chains_ending_at(job.task):
            t0 = self._sink_src.get((chain.name, job.jid))
            if t0 is None:
                continue
            lat = self.now - t0
            violated = lat > chain.deadline_s + 1e-12 or job.degraded
            if frec is not None:
                frec.emit(
                    self.now, "chain_complete", jid=job.jid, task=job.task,
                    chain=chain.name, value=lat,
                    data={
                        "t0": t0,
                        "deadline_s": chain.deadline_s,
                        "src_task": chain.nodes[0],
                        "violated": violated,
                    },
                )
                if lat > chain.deadline_s + 1e-12:
                    frec.emit(
                        self.now, "deadline_miss", jid=job.jid,
                        task=job.task, chain=chain.name,
                        value=lat - chain.deadline_s,
                    )
            self.chain_count[chain.name] += 1
            if self.cfg.collect_latencies:
                self.chain_latencies[chain.name].append(lat)
            if violated:
                self.chain_violations[chain.name] += 1
            if self._deg_open:
                self._deg_note(violated)
            if self.cfg.scenario is not None:
                # attribute to the mode active at the source sample time
                m = self.cfg.scenario.mode_at(t0)
                rec = self._sink_by_mode.setdefault((chain.name, m), [0, 0])
                rec[0] += 1
                rec[1] += int(violated)
                if self.cfg.collect_latencies:
                    self._mode_lats.setdefault(m, []).append(lat)

    def _record_dropped_sink(self, job: Job) -> None:
        for chain in self.wf.chains_ending_at(job.task):
            if self._rec is not None:
                self._rec.emit(
                    self.now, "chain_drop", jid=job.jid, task=job.task,
                    chain=chain.name,
                )
            self.chain_count[chain.name] += 1
            self.chain_violations[chain.name] += 1
            if self._deg_open:
                self._deg_note(True)
            if self.cfg.scenario is not None:
                t0 = self._sink_src.get((chain.name, job.jid), job.release)
                m = self.cfg.scenario.mode_at(t0)
                rec = self._sink_by_mode.setdefault((chain.name, m), [0, 0])
                rec[0] += 1
                rec[1] += 1

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def run(self) -> SimReport:
        with metrics.phase("engine_run"):
            return self._run()

    def _run(self) -> SimReport:
        self._prime()
        step = self._step
        while step():
            pass
        return self._finalize()

    # The loop is split into pure step functions so an external driver
    # (the batched lockstep engine in batch.py) can interleave many
    # simulators event-by-event: _prime() once, then _step() until it
    # returns False (heap drained or horizon crossed), then _finalize().
    def _prime(self) -> None:
        # insertion-ordered ready sets: Job hashes by identity, so a
        # plain set iterates in address order, which is only
        # accidentally stable. Dict keys preserve insertion order and
        # make tie-breaking in policy sorts reproducible across
        # processes (and mirrorable by the batched engine).
        self._ready_sets: List[Dict[Job, None]] = [{} for _ in self.parts]
        self.policy.setup(self)

        rec = self._rec
        if rec is not None:
            rec.meta.update(
                duration_s=self.cfg.duration_s,
                seed=self.cfg.seed,
                total_tiles=self.hw.num_tiles,
                policy=type(self.policy).__name__,
                partitions=[p.capacity for p in self.parts],
            )
            rec.emit(
                0.0, "schedule", value=self.schedule.peak_tiles,
                data={"partitions": [p.capacity for p in self.parts]},
            )
            # rate-regime seams (the piecewise unroll's boundaries)
            for r0, _r1, wf_r in self._regimes[1:]:
                rec.emit(r0, "rate_seam", value=wf_r.hyper_period_s)

        # seed events: sensor jobs are released by hardware timers
        for job in self.jobs:
            if job.is_sensor:
                self._push(job.release, "sensor", (job.jid,))

        # seed degradation events (docs/degradation.md): begin at the
        # event's onset, end when its platform effect lifts.  Permanent
        # events (end at the horizon) never fire an end event — the
        # heap stops at the horizon anyway.  Dropout storms act purely
        # through the trace (STREAM_DEGRADE drop verdicts) but still
        # open an accounting window here.
        for di, d in enumerate(self._degrades):
            t0 = getattr(d, "start_s", 0.0)
            if t0 >= self._end_t:
                continue
            self._push(t0, "degrade", (di, True))
            t1 = d.end_s(self._end_t)
            if t1 < self._end_t:
                self._push(t1, "degrade", (di, False))

        # seed mode-switch events from the scenario timeline (adjacent
        # equal-mode segments are one context: no event, no switch)
        scen = self.cfg.scenario
        if scen is not None:
            self._mode_now = scen.mode_at(0.0)
            prev = self._mode_now
            for t, mode in scen.boundaries()[1:]:
                if mode != prev and t < self.cfg.duration_s:
                    self._push(t, "mode_change", (mode,))
                prev = mode
            # a predictive replanner needs to arm its first forecast
            # before the clock starts (there is no t=0 mode_change)
            rep = getattr(self.policy, "replanner", None)
            if rep is not None and hasattr(rep, "on_run_start"):
                rep.on_run_start(self, self._mode_now, 0.0)

    def _step(self) -> bool:
        """Pop and dispatch one event. Returns False when drained."""
        heap = self._heap
        if not heap:
            return False
        t, _, kind, payload = heapq.heappop(heap)
        if t > self.cfg.duration_s:
            return False
        self.now = t
        self._dispatch(kind, payload)
        return True

    def _dispatch(self, kind: str, payload: tuple) -> None:
        rec = self._rec
        if kind == "sensor":
            job = self.jobs[payload[0]]
            if job.drop_at_release:
                # scenario dropout: the frame never arrives;
                # downstream jobs run degraded
                self.terminate(job, "sensor_dropout")
                return
            job.state = JobState.RUNNING
            job.start_t = self.now
            if rec is not None:
                rec.emit(
                    self.now, "job_release", jid=job.jid, task=job.task,
                )
            self._push(self.now + job.io_s, "sensor_done", (job.jid,))
        elif kind == "sensor_done":
            self._finish_job(self.jobs[payload[0]])
        elif kind == "ready":
            job = self.jobs[payload[0]]
            if job.state == JobState.READY:
                self.policy.on_point(self, job.partition, self.now, "ready", job)
        elif kind == "ert":
            job = self.jobs[payload[0]]
            if job.state == JobState.READY:
                self.policy.on_point(self, job.partition, self.now, "ert", job)
        elif kind == "finish":
            jid, gen = payload
            job = self.jobs[jid]
            if job.gen != gen or job.state != JobState.RUNNING:
                return
            self._advance_job(job)
            self._finish_job(job)
            if self._drain_watch is not None:
                # drain-aware activation: allocation just dropped —
                # let the replanner re-check before the policy
                # refills the freed tiles under the old table
                self.policy.on_forecast(self, self._drain_watch, self.now)
            self.policy.on_point(self, job.partition, self.now, "finish", job)
        elif kind == "chunk":
            jid, gen = payload
            job = self.jobs[jid]
            if job.gen != gen or job.state != JobState.RUNNING:
                return
            self._advance_job(job)
            # re-arm next chunk boundary (chunk events only exist
            # for resizable jobs under chunk-using policies)
            n = self.cfg.n_chunks
            nxt = math.floor(job.progress * n + 1e-9) + 1
            if nxt < n and job.rate > 0:
                dt = (nxt / n - job.progress) / job.rate
                self._push(self.now + dt, "chunk", (job.jid, job.gen))
            self.policy.on_point(self, job.partition, self.now, "chunk", job)
        elif kind == "resume":
            if payload[0] >= len(self.parts):
                return  # partition retired by an online morph
            part = self.parts[payload[0]]
            if part.stall_end > self.now + 1e-12:
                return  # superseded by a longer stall (hot-swap)
            self._touch(part)
            part.stalled = False
            if rec is not None:
                rec.emit(self.now, "stall_end", partition=part.idx)
                rec.stall_end(part.idx, self.now)
            for jid in list(part.running):
                job = self.jobs[jid]
                self._advance_job(job)
                self._set_rate(job)
            self.policy.on_point(self, part.idx, self.now, "resume", None)
        elif kind == "timer":
            pid, jid = payload
            if pid >= len(self.parts):
                return  # partition retired by an online morph
            job = self.jobs[jid] if jid >= 0 else None
            if job is not None and job.state in (JobState.DONE, JobState.DROPPED):
                return
            self.policy.on_point(self, pid, self.now, "timer", job)
        elif kind == "forecast":
            if rec is not None:
                rec.emit(self.now, "forecast_fire")
            self.policy.on_forecast(self, payload[0], self.now)
        elif kind == "mode_change":
            mode = payload[0]
            # split tile-second accounting exactly at the boundary
            for part in self.parts:
                self._touch(part)
            self._mode_now = mode
            self.n_mode_switches += 1
            if rec is not None:
                rec.emit(self.now, "mode_change", info=mode)
            self.policy.on_mode_change(self, mode, self.now)
        elif kind == "degrade":
            self._on_degrade(payload[0], payload[1])

    def _finalize(self) -> SimReport:
        # drain accounting to end time
        end_t = self.cfg.duration_s
        self.now = end_t
        for part in self.parts:
            self._touch(part)
        if self._rec is not None:
            self._rec.finalize(end_t)
        return self._report()

    # ------------------------------------------------------------------
    def _chain_expectations(self) -> Dict[str, tuple]:
        """chain name -> (expected sink completions within the horizon,
        per-mode expected counts).  A pure function of the skeleton's
        sink map and the scenario timeline — trace- and
        policy-independent, so the batched lockstep engine computes it
        once per batch and injects it into every lane."""
        scen = self.cfg.scenario
        out: Dict[str, tuple] = {}
        for chain in self.wf.chains:
            expected = 0
            exp_mode: Dict[str, int] = {}
            for (cname, _jid), t0 in self._sink_src.items():
                if cname != chain.name:
                    continue
                if t0 + chain.deadline_s <= self.cfg.duration_s:
                    expected += 1
                    if scen is not None:
                        m = scen.mode_at(t0)
                        exp_mode[m] = exp_mode.get(m, 0) + 1
            out[chain.name] = (expected, exp_mode)
        return out

    def _report(self) -> SimReport:
        total = self.hw.num_tiles * self.cfg.duration_s
        # retired (morphed-away) partitions keep their accounting
        all_parts = self.parts + self._retired_parts
        busy = sum(p.busy_ts for p in all_parts)
        realloc = sum(p.realloc_ts for p in all_parts)
        dnn_jobs = [
            j for j in self.jobs
            if not j.is_sensor and j.release <= self.cfg.duration_s
        ]
        considered = [
            j for j in dnn_jobs
            if j.e2e_ddl <= self.cfg.duration_s  # had a chance to finish
        ]
        dropped = [j for j in considered if j.state == JobState.DROPPED]
        late = [
            j for j in considered
            if j.state == JobState.DONE and j.finish_t > j.e2e_ddl
        ]
        unfinished = [
            j for j in considered
            if j.state in (JobState.PENDING, JobState.READY, JobState.RUNNING)
        ]
        n_miss = len(dropped) + len(late) + len(unfinished)

        # chains whose sink never completed within the horizon count as
        # violations (starvation must not look like success)
        scen = self.cfg.scenario
        expectations = self._chain_expectations()
        for chain in self.wf.chains:
            expected, exp_mode = expectations[chain.name]
            have = self.chain_count[chain.name]
            deficit = max(0, expected - have)
            if deficit:
                self.chain_violations[chain.name] += deficit
                self.chain_count[chain.name] = expected
            # mirror per (chain, mode): attribute exactly the chain's
            # global deficit to modes with missing sinks (chronological
            # order), so per-mode totals always reconcile with the
            # global counters — a mode's shortfall can be offset by
            # bonus completions (deadline beyond the horizon) elsewhere
            if scen is not None and deficit:
                for m in scen.modes():
                    if m not in exp_mode:
                        continue
                    rec = self._sink_by_mode.setdefault((chain.name, m), [0, 0])
                    take = min(max(0, exp_mode[m] - rec[0]), deficit)
                    if take:
                        rec[0] += take
                        rec[1] += take
                        deficit -= take
                    if not deficit:
                        break

        p99 = {}
        for ch, lats in self.chain_latencies.items():
            p99[ch] = float(np.percentile(lats, 99)) if lats else float("nan")
        ratios = [r for p in all_parts for r in p.decision_ratios]

        # per-mode report slices
        mode_stats: Dict[str, ModeStats] = {}
        if scen is not None:
            bounds = scen.boundaries()
            ends = [t for t, _m in bounds[1:]]
            # a run longer than the script stays in the final mode, so
            # the last segment's end is the horizon itself
            ends.append(max(self.cfg.duration_s, bounds[-1][0]))
            spans: Dict[str, float] = {}
            for (t0, m), t1 in zip(bounds, ends):
                spans[m] = spans.get(m, 0.0) + max(
                    0.0,
                    min(t1, self.cfg.duration_s) - min(t0, self.cfg.duration_s),
                )
            for m, span in spans.items():
                done = sum(
                    rec[0] for (_c, mm), rec in self._sink_by_mode.items()
                    if mm == m
                )
                viol = sum(
                    rec[1] for (_c, mm), rec in self._sink_by_mode.items()
                    if mm == m
                )
                lats = self._mode_lats.get(m, [])
                denom = self.hw.num_tiles * span
                mode_stats[m] = ModeStats(
                    mode=m,
                    span_s=span,
                    n_completed=done,
                    n_violations=viol,
                    p99_s=(
                        float(np.percentile(np.asarray(lats), 99))
                        if lats else float("nan")
                    ),
                    effective_frac=(
                        self._mode_busy.get(m, 0.0) / denom if denom > 0 else 0.0
                    ),
                    realloc_frac=(
                        self._mode_realloc.get(m, 0.0) / denom if denom > 0 else 0.0
                    ),
                )

        # predictive replanning: copy the replanner's pre-stage counters
        rep = getattr(self.policy, "replanner", None)
        fstats = getattr(rep, "forecast_stats", None)
        if fstats is not None and not isinstance(fstats, ForecastStats):
            fstats = None

        return SimReport(
            duration_s=self.cfg.duration_s,
            total_tiles=self.hw.num_tiles,
            effective_frac=busy / total,
            realloc_frac=realloc / total,
            idle_frac=max(0.0, 1.0 - (busy + realloc) / total),
            dropped_work_frac=self.dropped_work_ts / total,
            n_realloc=sum(p.n_realloc for p in all_parts),
            realloc_bytes=sum(p.realloc_bytes for p in all_parts),
            n_jobs=len(considered),
            n_dropped=len(dropped),
            task_miss_rate=n_miss / max(len(considered), 1),
            chain_count=dict(self.chain_count),
            chain_violations=dict(self.chain_violations),
            chain_p99_s=p99,
            chain_latencies=dict(self.chain_latencies),
            decision_ratios=ratios,
            mode_stats=mode_stats,
            n_mode_switches=self.n_mode_switches,
            forecast=fstats,
            tiles_used=self._tiles_used,
            tiles_reserved_mean=(
                self._reserved_ts
                + self.schedule.peak_tiles
                * max(0.0, self.cfg.duration_s - self._reserved_t0)
            ) / self.cfg.duration_s,
            frontier_meta=self._frontier_meta,
            degrade=self._degrade_stats,
        )
