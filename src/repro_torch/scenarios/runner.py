"""Scenario experiment runner: one dispatching entry point + sweeps.

:func:`run` is the single entry point for scenario simulation.  It owns
backend selection and the per-spec fallback policy over three engines:

* ``"scalar"`` — the per-event reference engine (host NumPy), one run
  at a time; the semantics oracle;
* ``"lockstep"`` — the batched lockstep engine
  (:func:`~repro_torch.core.sim.batch.run_batch`, host NumPy); each
  lane's report is bit-identical to the scalar engine's;
* ``"soa"`` — the structure-of-arrays Monte-Carlo backend, which
  advances every seed of one cell as ``(R, N)`` tensors on the card
  (:mod:`repro_torch.core.sim.soa`); distributionally equivalent.

``backend="auto"`` (the default) picks as the JAX package's runner
does: the scalar engine for one run, lockstep for seed fans and
trace-sharing groups, and never the SoA backend unless asked for by
name.

Every entry point takes ``device="cuda"`` and resolves it first, for
every backend: without a CUDA device it raises unless the caller
passes ``device="cpu"``.  The exact engines run on the host whatever
the device; the SoA backend runs on ``device``.  ``fallback=True`` only
routes a spec outside the SoA support set (a degraded scenario, a
predictive replanner, a recorder) to the lockstep or scalar engine.

``sweep`` is the fleet-scale view: ``N`` Markov-sampled scenarios x
policies, fanned out over a ``spawn`` process pool with deterministic
per-scenario seeds, aggregated into per-policy and per-mode tables
(streaming form: :class:`repro_torch.sweeps.SweepReducer`).  Passing
``cache_dir=`` routes the sweep through the campaign service
(:mod:`repro_torch.sweeps.service`): rows become content-addressed
cache entries and repeated sweeps only execute new cells.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from collections import abc as _abc
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .._device import resolve_device
from ..core.experiment import ExperimentSpec, build_stack, make_policy
from ..core.runtime import (
    OnlineReplanner,
    PredictiveReplanner,
    SchedulePortfolio,
)
from ..core.sim import SimConfig, Simulator, SimReport
from ..core.sim.batch import LaneSimulator, run_batch, sample_trace_batch
from ..core.sim.trace import Trace, build_skeleton, sample_trace
from ..obs import TraceRecorder, attribution_report, metrics
from ..sweeps.executor import ItemFailure, LocalPoolExecutor
from ..sweeps.reduce import SweepReducer
from ..sweeps.rows import SweepRow
from .modes import get_mode, register_mode
from .script import MarkovScenarioGenerator, ScenarioScript, default_generator

__all__ = [
    "ScenarioSpec",
    "SweepBackend",
    "BackendRegistry",
    "SWEEP_BACKENDS",
    "compile_portfolio",
    "build_trace",
    "run",
    "soa_usable",
    "parallel_map",
    "ItemFailure",
    "summarize",
    "SweepRow",
    "SweepReducer",
    "sweep",
    "aggregate_sweep",
]


@dataclasses.dataclass
class ScenarioSpec(ExperimentSpec):
    """One scenario run (picklable, so sweeps can ship it to workers).

    Extends :class:`~repro_torch.core.experiment.ExperimentSpec` — the
    workload fields (tiles, replicas, deadlines, ...) live there — with
    the scenario script, the replanning switch, and a scenario-length
    default horizon.
    """

    scenario: Optional[ScenarioScript] = None   # required (kw-only in use)
    replan: bool = True
    #: how the replanner reacts to context shifts:
    #:   "reactive"   — hot-swap at the seam;
    #:   "predictive" — forecast-driven: pre-swap the full target table
    #:                  ahead of high-confidence seams, blend below;
    #:   "blend"      — hedge-only variant: every staged transition uses
    #:                  the blended table (ablation of the pre-swap).
    replan_mode: str = "reactive"
    #: predictive only: stage this many seconds before the forecast seam
    forecast_lead_s: float = 0.08
    #: reactive context-shift confirmation window (seconds): a runtime
    #: without a forecast detects a mode switch from observed
    #: statistics, swapping this long after the seam.  0 keeps the
    #: oracle-reactive behaviour.
    detection_delay_s: float = 0.0
    #: predictive only: pin switch times from the script itself (the
    #: route-informed case); False falls back to pure Markov+dwell
    #: estimation
    route_forecast: bool = True
    #: predicted E2E miss-probability target for the tile-budget
    #: autotuner: each mode installs the cheapest frontier point
    #: meeting it.  None keeps the most conservative feasible table per
    #: mode.  Ignored when a precompiled ``portfolio`` is supplied.
    target_miss: Optional[float] = None
    duration_s: Optional[float] = None          # None = the scenario's length
    #: precompiled per-mode schedules; None compiles one per run.
    #: sweep() fills this so N scenarios share one portfolio per policy
    #: instead of recompiling identical GHA tables in every worker.
    portfolio: Optional[SchedulePortfolio] = None
    #: mode definitions to (re-)register before running.  Spawned pool
    #: workers re-import the bundled registry only, so custom modes
    #: added via register_mode must travel with the spec; sweep() fills
    #: this automatically from the generator's mode set.
    mode_defs: Optional[Dict[str, object]] = None
    #: attach a flight recorder (:mod:`repro_torch.obs`) to the run: the
    #: report gains an ``attribution`` section (deadline-miss
    #: decomposition) and the recorder itself is reachable through
    #: ``run``'s ``recorders=`` argument for trace export.
    #: Off by default — recording a sweep costs memory per run.
    record: bool = False
    #: autotuned portfolios only (``target_miss`` set): pin every mode
    #: to one common partition count.  False lets each mode keep its
    #: own best spatial layout — hot-swaps then split/merge partitions
    #: online.
    harmonize_partitions: bool = True

    def __post_init__(self) -> None:
        if self.scenario is None:
            raise ValueError("ScenarioSpec requires a scenario script")
        if self.replan_mode not in ("reactive", "predictive", "blend"):
            raise ValueError(
                f"unknown replan_mode {self.replan_mode!r} "
                "(choose from reactive/predictive/blend)"
            )


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------
def soa_usable(spec: "ScenarioSpec") -> Tuple[bool, str]:
    """Whether the SoA backend can run ``spec`` (and why not).

    This is a question about the spec only: the device is the caller's
    choice, and a missing card raises instead of being routed around.
    """
    from ..core.sim import soa

    if not soa.soa_supported(
        spec.policy, spec.replan_mode, spec.detection_delay_s,
        spec.drop_policy, spec.record,
    ):
        return (
            False,
            f"spec (policy={spec.policy!r}, replan_mode={spec.replan_mode!r}, "
            f"record={spec.record}) is outside the SoA support set",
        )
    if getattr(spec.scenario, "has_degradations", False):
        return (
            False,
            "scenario injects platform degradations (engine seams the "
            "SoA round loop does not model)",
        )
    return True, ""


def _always_available() -> bool:
    return True


def _always_supported(_spec) -> Tuple[bool, str]:
    return True, ""


@dataclasses.dataclass(frozen=True)
class SweepBackend:
    """Capability metadata for one simulation engine.

    ``kind`` is the equivalence contract: ``"exact"`` backends produce
    bit-identical reports to each other, ``"distributional"`` ones
    agree statistically (KS / CI-overlap gates).
    """

    name: str
    #: "exact" | "distributional"
    kind: str
    #: runs many lanes in one call (seed fans)
    batched: bool
    description: str
    #: process-wide availability
    is_available: Callable[[], bool] = _always_available
    #: per-spec support: ``(ok, reason_if_not)``
    supports: Callable[[object], Tuple[bool, str]] = _always_supported


class BackendRegistry(_abc.Mapping):
    """Name -> :class:`SweepBackend` mapping (iterates over names)."""

    def __init__(self, *backends: SweepBackend) -> None:
        self._by_name: Dict[str, SweepBackend] = {}
        for b in backends:
            self.register(b)

    def register(self, backend: SweepBackend, overwrite: bool = False) -> SweepBackend:
        if backend.name in self._by_name and not overwrite:
            raise ValueError(f"backend {backend.name!r} already registered")
        if backend.kind not in ("exact", "distributional"):
            raise ValueError(f"unknown backend kind {backend.kind!r}")
        self._by_name[backend.name] = backend
        return backend

    def __getitem__(self, name: str) -> SweepBackend:
        return self._by_name[name]

    def __iter__(self):
        return iter(self._by_name)

    def __len__(self) -> int:
        return len(self._by_name)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._by_name)

    def __repr__(self) -> str:
        return repr(self.names())


#: engines :func:`run` can route work through, with their capability
#: metadata
SWEEP_BACKENDS = BackendRegistry(
    SweepBackend(
        name="scalar", kind="exact", batched=False,
        description="per-event reference engine, one run at a time",
    ),
    SweepBackend(
        name="lockstep", kind="exact", batched=True,
        description=(
            "batched lockstep engine; per-lane reports bit-identical "
            "to scalar"
        ),
    ),
    SweepBackend(
        name="soa", kind="distributional", batched=True,
        description=(
            "structure-of-arrays torch backend on the card (ladder grant "
            "as a CUDA kernel); distributionally equivalent to scalar"
        ),
        supports=soa_usable,
    ),
)


def _check_backend(backend: str, *, allow_auto: bool = False) -> None:
    if backend in SWEEP_BACKENDS or (allow_auto and backend == "auto"):
        return
    choices = (("auto",) if allow_auto else ()) + SWEEP_BACKENDS.names()
    raise ValueError(f"unknown backend {backend!r} (choose from {choices})")


# ---------------------------------------------------------------------------
# compilation / trace helpers
# ---------------------------------------------------------------------------
def compile_portfolio(
    spec: ScenarioSpec, modes: Optional[Sequence[str]] = None, **autotune_kw
) -> SchedulePortfolio:
    """Compile the per-mode schedule portfolio for ``spec``'s workload
    (``modes`` defaults to the scenario's own mode set).

    ``spec.target_miss`` (or any explicit ``autotune_kw``) engages the
    tile-budget autotuner's joint search; the default compiles each
    mode's most conservative feasible table.
    """
    wf, _hw, model, compiler = build_stack(spec)
    wanted = tuple(modes) if modes is not None else spec.scenario.modes()
    autotune_kw.setdefault("target_miss", spec.target_miss)
    autotune_kw.setdefault("harmonize_partitions", spec.harmonize_partitions)
    return SchedulePortfolio.compile(
        model, wf, {m: get_mode(m) for m in wanted}, compiler, **autotune_kw,
    )


def build_trace(spec: ScenarioSpec) -> Trace:
    """Sample the full randomness of one scenario run up front (the
    draws are policy-independent, so one trace serves every policy /
    replan variant of the same ``(scenario, seed, workload)``)."""
    wf, _hw, model, _compiler = build_stack(spec)
    scen = spec.scenario
    duration = scen.duration_s if spec.duration_s is None else spec.duration_s
    skel = build_skeleton(wf, scen, duration)
    return sample_trace(skel, model, scen, spec.seed)


def _prepare_run(spec: ScenarioSpec):
    """The per-run setup shared by every backend: mode registration,
    workload stack, and the offline schedule portfolio."""
    if spec.mode_defs:
        for mode in spec.mode_defs.values():
            register_mode(mode, overwrite=True)
    scen = spec.scenario
    wf, _hw, model, compiler = build_stack(spec)

    # the offline table is compiled for the scenario's *initial* mode
    # (via the portfolio's q-relaxation ladder, so pinned and replanned
    # runs start from the identical table) — a pinned run then keeps it
    # for the whole drive
    initial_mode = scen.segments[0].mode
    portfolio = spec.portfolio
    if portfolio is None:
        wanted = scen.modes() if spec.replan else (initial_mode,)
        portfolio = SchedulePortfolio.compile(
            model, wf, {m: get_mode(m) for m in wanted}, compiler,
            target_miss=spec.target_miss,
            harmonize_partitions=spec.harmonize_partitions,
        )
    return wf, model, portfolio.schedules[initial_mode], portfolio


def _make_run_policy(spec: ScenarioSpec, portfolio: SchedulePortfolio):
    """Fresh policy (+ replanner) instance for one run/lane; the
    compiled portfolio itself is read-only and shared."""
    scen = spec.scenario
    policy = make_policy(spec.policy)
    if spec.replan:
        if spec.replan_mode == "reactive":
            policy.replanner = OnlineReplanner(
                portfolio, detection_delay_s=spec.detection_delay_s
            )
        else:
            kw = dict(
                forecaster=scen.forecaster(route_informed=spec.route_forecast),
                lead_s=spec.forecast_lead_s,
                detection_delay_s=spec.detection_delay_s,
            )
            if spec.replan_mode == "blend":
                # hedge-only ablation: no forecast is confident enough
                # for a full pre-swap, every stage blends
                kw["confidence_hi"] = 2.0
            policy.replanner = PredictiveReplanner(portfolio, **kw)
    return policy


def _sim_config(
    spec: ScenarioSpec, trace: Optional[Trace], rec: Optional[TraceRecorder],
) -> SimConfig:
    scen = spec.scenario
    return SimConfig(
        duration_s=(
            scen.duration_s if spec.duration_s is None else spec.duration_s
        ),
        seed=spec.seed,
        drop_policy=spec.drop_policy,
        scenario=scen,
        trace=trace,
        recorder=rec,
    )


# ---------------------------------------------------------------------------
# backend implementations (private; dispatch through run())
# ---------------------------------------------------------------------------
def _run_single(
    spec: ScenarioSpec,
    trace: Optional[Trace] = None,
    recorder: Optional[TraceRecorder] = None,
) -> SimReport:
    """Scalar reference engine: one scenario end-to-end."""
    wf, model, sched, portfolio = _prepare_run(spec)
    policy = _make_run_policy(spec, portfolio)
    rec = recorder
    if rec is None and spec.record:
        rec = TraceRecorder()
    sim = Simulator(
        wf, model, sched, policy, _sim_config(spec, trace, rec),
    )
    report = sim.run()
    if rec is not None:
        report.attribution = attribution_report(sim, rec)
    return report


def _run_lockstep_seeds(
    spec: ScenarioSpec,
    seeds: Sequence[int],
    recorders: Optional[Mapping[int, TraceRecorder]] = None,
) -> List[SimReport]:
    """Lockstep engine, seed fan: ``len(seeds)`` Monte-Carlo drives of
    one spec as lanes of one batch.

    Each lane's report is bit-identical to the scalar engine run with
    that seed — the stack/portfolio setup is shared, the
    stream-contract trace is batch-materialized once on the host
    (:func:`~repro_torch.core.sim.batch.sample_trace_batch` with
    ``device=None``: the torch sampler's last-ulp differences would
    break bit-identity) and the lanes advance in lockstep
    (:func:`~repro_torch.core.sim.batch.run_batch`).

    ``recorders`` attaches flight recorders to individual lanes by seed
    *index* — a recorded lane de-batches to the scalar per-lane driver
    (recorder hooks live on the engine paths the fused loop elides) but
    stays inside the lockstep loop; ``spec.record`` attaches one to
    every lane.
    """
    wf, model, sched, portfolio = _prepare_run(spec)
    scen = spec.scenario
    duration = scen.duration_s if spec.duration_s is None else spec.duration_s
    skel = build_skeleton(wf, scen, duration)
    btrace = sample_trace_batch(skel, model, scen, seeds)

    sims: List[LaneSimulator] = []
    recs: List[Optional[TraceRecorder]] = []
    for k, s in enumerate(seeds):
        rec = recorders.get(k) if recorders is not None else None
        if rec is None and spec.record:
            rec = TraceRecorder()
        lane_spec = dataclasses.replace(spec, seed=int(s))
        sims.append(LaneSimulator(
            wf, model, sched, _make_run_policy(lane_spec, portfolio),
            _sim_config(lane_spec, btrace.lane(k), rec),
        ))
        recs.append(rec)
    reports = run_batch(sims)
    for sim, rec, report in zip(sims, recs, reports):
        if rec is not None:
            report.attribution = attribution_report(sim, rec)
    return reports


def _run_lockstep_group(
    specs: Sequence[ScenarioSpec],
    trace: Optional[Trace] = None,
    recorders: Optional[Mapping[int, TraceRecorder]] = None,
) -> List[SimReport]:
    """Lockstep engine, policy group: several specs sharing (scenario,
    seed, workload), differing in policy/replan, as lanes of one batch
    sharing ``trace``.

    Reports are bit-identical to the scalar engine per spec; this is
    the batched path under :func:`sweep`.
    """
    sims: List[LaneSimulator] = []
    recs: List[Optional[TraceRecorder]] = []
    for i, spec in enumerate(specs):
        wf, model, sched, portfolio = _prepare_run(spec)
        rec = recorders.get(i) if recorders is not None else None
        if rec is None and spec.record:
            rec = TraceRecorder()
        sims.append(LaneSimulator(
            wf, model, sched, _make_run_policy(spec, portfolio),
            _sim_config(spec, trace, rec),
        ))
        recs.append(rec)
    reports = run_batch(sims)
    for sim, rec, report in zip(sims, recs, reports):
        if rec is not None:
            report.attribution = attribution_report(sim, rec)
    return reports


#: per-process memo of SoA window pads that proved necessary, keyed by
#: (skeleton key, policy, drop policy, duration) — see _run_soa
_SOA_LIFE_PAD_HINT: Dict[tuple, float] = {}


def _run_soa(
    spec: ScenarioSpec,
    seeds: Sequence[int],
    options=None,
    device="cuda",
) -> List[SimReport]:
    """Structure-of-arrays backend, seed fan, on ``device``.

    Reports agree with the scalar engine *distributionally* (KS on
    chain latencies, CI overlap on summary rates) and *exactly* on
    structural invariants.  Raises
    :class:`repro_torch.core.sim.soa.SoaUnsupported` when the spec is
    outside the support set; :func:`run` owns the fallback decision.
    """
    from ..core.sim import soa

    ok, why = soa_usable(spec)
    if not ok:
        raise soa.SoaUnsupported(why)
    wf, model, sched, portfolio = _prepare_run(spec)
    scen = spec.scenario
    duration = scen.duration_s if spec.duration_s is None else spec.duration_s
    skel = build_skeleton(wf, scen, duration)
    btrace = sample_trace_batch(skel, model, scen, seeds, device=device)
    # overloaded cells under drop_policy="soft" can queue jobs past the
    # default job-window lifetime bound; the backend refuses to return
    # truncated results (SoaWindowOverflow), so retry wider: first a
    # doubled window (mild overruns), then one capped at the horizon —
    # full job coverage, structurally incapable of overflowing.  A pad
    # that worked is remembered per cell so repeat calls skip the
    # discarded detection run; the hint only ever *widens* the default,
    # and only applies when the caller did not pass explicit options.
    hint_key = (skel.key, spec.policy, spec.drop_policy, float(duration))
    opt0 = options if options is not None else soa.SoaOptions(
        life_pad_s=_SOA_LIFE_PAD_HINT.get(hint_key, 0.0)
    )
    opt = opt0
    for attempt in range(3):
        with metrics.phase("soa_build"):
            problem = soa.build_problem(
                wf, model, sched, portfolio,
                _make_run_policy(spec, portfolio), scen, duration,
                replan=spec.replan, n_lanes=len(seeds),
                drop_policy=spec.drop_policy, options=opt,
            )
        try:
            reports = soa.run_problem(problem, btrace, seeds, device=device)
        except soa.SoaWindowOverflow:
            if problem.life >= duration or attempt == 2:
                raise
            metrics.count("soa_window_retries")
            warnings.warn(
                f"SoA job window ({problem.life:.3f}s) overflowed under "
                "overload; retrying with a "
                + ("doubled" if attempt == 0 else "full-horizon")
                + " window",
                RuntimeWarning,
                stacklevel=2,
            )
            pad = problem.life if attempt == 0 else duration
            opt = dataclasses.replace(
                opt0, life_pad_s=opt0.life_pad_s + pad
            )
        else:
            if options is None and opt.life_pad_s > _SOA_LIFE_PAD_HINT.get(
                hint_key, 0.0
            ):
                _SOA_LIFE_PAD_HINT[hint_key] = opt.life_pad_s
            return reports


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def run(
    specs: Union[ScenarioSpec, Sequence[ScenarioSpec]],
    *,
    seeds: Optional[Sequence[int]] = None,
    backend: str = "auto",
    trace: Optional[Trace] = None,
    recorders: Optional[Mapping[int, TraceRecorder]] = None,
    options=None,
    fallback: bool = True,
    device="cuda",
) -> List[SimReport]:
    """Run scenario simulations; always returns one report per run.

    The one entry point over every engine.  Three call shapes:

    * ``run(spec)`` — a single drive (``run(spec)[0]`` is the report);
    * ``run(spec, seeds=[...])`` — a Monte-Carlo *seed fan* of one
      spec, one report per seed;
    * ``run([spec_a, spec_b, ...])`` — a *group* of specs (typically
      one scenario+seed across policies), one report per spec, in
      order.

    ``backend`` selects the engine (see :data:`SWEEP_BACKENDS`):

    * ``"auto"`` (default) — deterministic best choice: the scalar
      reference engine for a single run, the bit-identical lockstep
      engine for seed fans, and for groups the lockstep engine over
      maximal sub-groups that can share a trace (same scenario, seed
      and workload), sampling each shared trace once.  Never picks the
      SoA backend — its rows are only distributionally equivalent, so
      it must be asked for by name.
    * ``"scalar"`` / ``"lockstep"`` — force that exact-family engine.
    * ``"soa"`` — the distributional backend on ``device``.  Specs it
      cannot run (unsupported feature, attached recorder) fall back to
      an exact engine when ``fallback=True`` (the sweep default) or
      raise ``SoaUnsupported`` when ``fallback=False``.

    ``device`` defaults to ``"cuda"`` and is checked first, for every
    backend: without a CUDA device the call raises unless the caller
    passes ``device="cpu"``.  The exact engines run on the host.

    ``trace`` injects presampled randomness (:func:`build_trace`) into
    exact-engine runs; a group sharing one trace must share (scenario,
    seed, workload).  Incompatible with ``seeds=`` (a trace carries
    one seed's draws) and with the SoA backend (it materializes its
    own trace batch).

    ``recorders`` maps run index (seed index for fans, spec index for
    groups, ``0`` for a single spec) to a caller-owned
    :class:`~repro_torch.obs.TraceRecorder`; ``spec.record`` instead
    attaches an internal one to every run.  Either way recorded reports
    carry an ``attribution`` section.

    ``options`` passes :class:`~repro_torch.core.sim.soa.SoaOptions`
    through to the SoA backend (SoA-only).
    """
    dev = resolve_device(device)
    single = isinstance(specs, ScenarioSpec)
    spec_list: List[ScenarioSpec] = [specs] if single else list(specs)
    _check_backend(backend, allow_auto=True)
    if not spec_list:
        return []
    if options is not None and backend != "soa":
        raise ValueError("options= configures the SoA backend; pass backend='soa'")
    if seeds is not None:
        if not single:
            raise ValueError(
                "seeds= fans one spec over Monte-Carlo seeds; pass a "
                "single spec (a list of specs is a group, one run each)"
            )
        if trace is not None:
            raise ValueError(
                "trace= carries one seed's presampled draws; it cannot "
                "be combined with seeds= (the engine batch-materializes "
                "the fan's traces itself)"
            )
        return _dispatch_seed_fan(
            spec_list[0], [int(s) for s in seeds], backend, recorders,
            options, fallback, dev,
        )
    return _dispatch_group(
        spec_list, backend, trace, recorders, options, fallback, dev,
    )


def _dispatch_seed_fan(
    spec: ScenarioSpec,
    seeds: List[int],
    backend: str,
    recorders: Optional[Mapping[int, TraceRecorder]],
    options,
    fallback: bool,
    dev,
) -> List[SimReport]:
    if backend == "soa":
        ok, why = soa_usable(spec)
        if ok and recorders:
            ok, why = False, "recorders need engine hooks the SoA kernel elides"
        if ok:
            return _run_soa(spec, seeds, options, dev)
        if not fallback:
            from ..core.sim import soa

            raise soa.SoaUnsupported(why)
        return _run_lockstep_seeds(spec, seeds, recorders)
    if backend == "scalar":
        out: List[SimReport] = []
        for k, s in enumerate(seeds):
            rec = recorders.get(k) if recorders is not None else None
            out.append(
                _run_single(dataclasses.replace(spec, seed=int(s)), None, rec)
            )
        return out
    # auto / lockstep: the batched exact engine is the right default
    return _run_lockstep_seeds(spec, seeds, recorders)


def _dispatch_group(
    spec_list: List[ScenarioSpec],
    backend: str,
    trace: Optional[Trace],
    recorders: Optional[Mapping[int, TraceRecorder]],
    options,
    fallback: bool,
    dev,
) -> List[SimReport]:
    recorders = recorders or {}
    if backend == "soa":
        if trace is not None:
            raise ValueError(
                "the SoA backend materializes its own device trace; "
                "trace= is only valid for exact backends"
            )
        out: List[SimReport] = []
        for i, spec in enumerate(spec_list):
            rec = recorders.get(i)
            ok, why = soa_usable(spec)
            if ok and rec is not None:
                ok, why = False, "recorders need engine hooks the SoA kernel elides"
            if ok:
                out.append(_run_soa(spec, [spec.seed], options, dev)[0])
            elif fallback:
                out.append(_run_single(spec, None, rec))
            else:
                from ..core.sim import soa

                raise soa.SoaUnsupported(why)
        return out
    if backend == "lockstep":
        return _run_lockstep_group(spec_list, trace, recorders or None)
    if backend == "scalar":
        return [
            _run_single(s, trace, recorders.get(i))
            for i, s in enumerate(spec_list)
        ]
    # auto
    if len(spec_list) == 1:
        return [_run_single(spec_list[0], trace, recorders.get(0))]
    if trace is not None:
        # the caller vouches the group shares the trace's (scenario,
        # seed, workload) — the batch engine's skeleton guard backstops
        return _run_lockstep_group(spec_list, trace, recorders or None)
    out2: List[Optional[SimReport]] = [None] * len(spec_list)
    for idxs in _auto_groups(spec_list):
        if len(idxs) == 1:
            i = idxs[0]
            out2[i] = _run_single(spec_list[i], None, recorders.get(i))
        else:
            sub = [spec_list[i] for i in idxs]
            shared = build_trace(sub[0])
            sub_recs = {
                j: recorders[i]
                for j, i in enumerate(idxs) if i in recorders
            }
            reports = _run_lockstep_group(sub, shared, sub_recs or None)
            for j, i in enumerate(idxs):
                out2[i] = reports[j]
    return out2  # type: ignore[return-value]


#: ExperimentSpec/ScenarioSpec fields that shape the sampled trace and
#: skeleton; specs agreeing on all of them (plus scenario and seed) can
#: share one trace as lockstep lanes.  Policy/replan fields are absent
#: on purpose — draws are policy-independent (counter-based streams).
_TRACE_FIELDS = (
    "seed", "duration_s", "tiles", "cockpit_replicas", "load_factor",
    "deadline_s", "q", "num_partitions", "p99_ratio", "dram_utilization",
    "drop_policy",
)


def _auto_groups(spec_list: Sequence[ScenarioSpec]) -> List[List[int]]:
    """Partition specs into trace-sharing groups (order-stable).

    Keys are compared by equality, not hashed: the profile token holds
    ``DrivingMode`` values, whose dict fields make them unhashable (the
    JAX package's dict-keyed version raises ``TypeError`` there, so its
    ``run([...])`` of two or more specs without ``trace=`` fails).
    """
    keys: List[tuple] = []
    groups: List[List[int]] = []
    for i, spec in enumerate(spec_list):
        key = (
            spec.scenario.cache_token(),
            spec.scenario.profile_token(),
            tuple(getattr(spec, f) for f in _TRACE_FIELDS),
        )
        for k, group in zip(keys, groups):
            if k == key:
                group.append(i)
                break
        else:
            keys.append(key)
            groups.append([i])
    return groups


# ---------------------------------------------------------------------------
# process-pool utility
# ---------------------------------------------------------------------------
def parallel_map(
    fn: Callable,
    items: Sequence,
    jobs: Optional[int] = None,
    *,
    return_errors: bool = False,
) -> List:
    """``[fn(x) for x in items]``, fanned out over ``jobs`` processes.

    Thin wrapper over :class:`repro_torch.sweeps.LocalPoolExecutor`:
    order preserved, ``spawn`` start method (forking after CUDA has
    been initialised is unsafe), ``jobs=None`` uses the CPU count
    capped at the number of items, ``jobs`` <= 1 or a single item
    degrades to a plain in-process loop, so ``fn`` and every item must
    be picklable.

    Error handling is per-item: a failing item does not abort the pool
    mid-pass nor discard its siblings' completed results.  With
    ``return_errors=True`` failures come back in place as
    :class:`~repro_torch.sweeps.ItemFailure` entries; otherwise the
    first failure's original exception re-raises after the full pass.
    """
    return LocalPoolExecutor(jobs).map(fn, items, return_errors=return_errors)


# ---------------------------------------------------------------------------
# Monte-Carlo sweeps
# ---------------------------------------------------------------------------
def summarize(spec: ScenarioSpec, report: SimReport) -> Dict[str, object]:
    """Flatten one run into a picklable summary row — the dict form of
    :class:`repro_torch.sweeps.SweepRow` (``SweepRow.from_report`` is
    the typed equivalent; the dict shape is what the result cache
    stores)."""
    return SweepRow.from_report(spec, report).to_dict()


def _run_one(spec: ScenarioSpec) -> Dict[str, object]:
    return summarize(spec, _run_single(spec))


def _run_group(
    specs: Sequence[ScenarioSpec], backend: str = "lockstep", device="cuda",
) -> List[Dict[str, object]]:
    """Run every spec of one scenario seed, sampling its trace once.

    All specs in a group share (scenario, seed, workload) and differ
    only in policy/replan, so one trace serves them all: the paired
    policy comparison stays exact at the job level while the sampling
    cost is paid once instead of once per policy.

    ``backend`` selects the engine (see :data:`SWEEP_BACKENDS`):

    * ``"lockstep"`` (default) — the batched lockstep engine; per-lane
      reports are bit-identical to the scalar path, so sweep rows are
      unchanged.
    * ``"scalar"`` — the per-event reference engine, one spec at a
      time.
    * ``"soa"`` — the structure-of-arrays backend on ``device``.  Rows
      are distributionally (not bitwise) equivalent to the other two.
      A sweep group holds *one* seed per scenario, the SoA backend's
      worst shape, so this selector exists for apples-to-apples
      validation sweeps; throughput work should call ``run(spec,
      seeds=..., backend="soa")`` with many seeds per cell instead.
      Specs outside the SoA support set fall back to the scalar engine.

    ``device`` is resolved first, for every backend.
    """
    _check_backend(backend)
    dev = resolve_device(device)
    if backend == "soa":
        reports = run(list(specs), backend="soa", fallback=True, device=dev)
        return [summarize(s, r) for s, r in zip(specs, reports)]
    if len(specs) <= 1 or backend == "scalar":
        return [summarize(s, _run_single(s)) for s in specs]
    trace = build_trace(specs[0])
    reports = _run_lockstep_group(specs, trace)
    return [summarize(s, r) for s, r in zip(specs, reports)]


def sweep(
    n_scenarios: int,
    policies: Sequence[str] = ("ads_tile", "tp_driven"),
    duration_s: float = 2.0,
    seed: int = 0,
    jobs: Optional[int] = None,
    generator: Optional[MarkovScenarioGenerator] = None,
    replan: bool = True,
    backend: str = "lockstep",
    cache_dir=None,
    manifest_path=None,
    device="cuda",
    **spec_kw,
) -> List[Dict[str, object]]:
    """Monte-Carlo sweep: ``n_scenarios`` Markov drives x ``policies``.

    Scenario ``i`` is sampled with the deterministic seed
    ``seed * 100003 + i`` and simulated with the same seed for every
    policy, so policy comparisons are paired and the whole sweep is
    reproducible from ``seed`` alone.  The unit of parallel work is one
    *scenario* (all its policies run in the same worker, sharing one
    sampled trace and one cached structural skeleton).

    ``backend`` selects the per-group engine (see :func:`_run_group`):
    ``"lockstep"`` (default, bit-identical rows), ``"scalar"``
    (reference engine), or ``"soa"`` (distributionally-equivalent
    backend on ``device``; per-scenario set-up makes it the validation
    shape here, not the throughput shape — use ``run(spec, seeds=...,
    backend="soa")`` directly for many-seed cells).  ``device`` is
    resolved first and travels to every worker; it is not part of a
    cell key.

    ``cache_dir`` routes the sweep through the campaign service
    (:func:`repro_torch.sweeps.run_campaign`): rows are stored
    content-addressed on disk, so an identical repeat sweep executes
    zero cells and an extended one executes only the new cells.
    ``manifest_path`` additionally writes the resumable campaign
    manifest there (requires ``cache_dir``).  Rows are identical to the
    direct path either way.
    """
    dev = resolve_device(device)
    if cache_dir is not None:
        from ..sweeps.service import CampaignSpec, run_campaign

        campaign = CampaignSpec(
            name="sweep",
            n_scenarios=n_scenarios,
            policies=tuple(policies),
            scenario_duration_s=duration_s,
            seed=seed,
            replan=replan,
            backend=backend,
            generator=generator,
            spec_kw=dict(spec_kw),
        )
        return run_campaign(
            campaign, cache_dir=cache_dir, manifest_path=manifest_path,
            jobs=jobs, device=dev,
        ).rows
    if manifest_path is not None:
        raise ValueError("manifest_path= requires cache_dir= (campaign mode)")
    gen = generator or default_generator()
    all_modes = sorted(gen.transitions)
    mode_defs = {m: get_mode(m) for m in all_modes}
    groups: List[List[ScenarioSpec]] = []
    portfolios: Dict[str, SchedulePortfolio] = {}
    for i in range(n_scenarios):
        s_i = seed * 100003 + i
        script = gen.sample(duration_s, seed=s_i)
        group: List[ScenarioSpec] = []
        for pol in policies:
            spec = ScenarioSpec(
                scenario=script, policy=pol, replan=replan, seed=s_i,
                mode_defs=mode_defs,
                **spec_kw,
            )
            # one portfolio per policy, covering every mode the
            # generator can emit — compiled here once instead of per
            # worker run
            if pol not in portfolios:
                portfolios[pol] = compile_portfolio(spec, all_modes)
            group.append(dataclasses.replace(spec, portfolio=portfolios[pol]))
        groups.append(group)
    rows_per_group = parallel_map(
        functools.partial(_run_group, backend=backend, device=str(dev)),
        groups, jobs,
    )
    return [row for rows in rows_per_group for row in rows]


def aggregate_sweep(
    rows: Sequence[Mapping[str, object]],
) -> Dict[str, Dict[str, object]]:
    """Aggregate sweep rows into per-policy means (and per-mode means).

    Returns ``{policy: {n, violation_rate, task_miss_rate,
    realloc_frac, per_mode: {mode: {...}}}}``.  Rows from recorded runs
    (``ScenarioSpec(record=True)``) additionally aggregate online into
    an ``attribution`` entry: summed lateness decomposed into
    queueing / realloc-stall / re-stagger / duration-tail seconds, so a
    sweep can print *why* a policy misses, not just how often.

    Thin batch wrapper over the streaming
    :class:`repro_torch.sweeps.SweepReducer` — the two are equal by
    construction; use the reducer directly when rows arrive
    incrementally (campaigns, shard workers).
    """
    return SweepReducer().update_many(rows).result()
