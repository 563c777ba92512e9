"""Scenario experiment runner: the :func:`run` entry point.

:func:`run` owns backend selection and the per-spec fallback policy.
This port carries two engines:

* ``"scalar"`` — the per-event reference engine (host NumPy), one run
  at a time; the port's semantics oracle;
* ``"soa"`` — the structure-of-arrays Monte-Carlo backend, which
  advances every seed of one cell as ``(R, N)`` tensors on the card
  (:mod:`repro_torch.core.sim.soa`).

Every entry point takes ``device="cuda"``.  Without a CUDA device it
raises unless the caller passes ``device="cpu"``: a missing card is
never routed around.  ``fallback=True`` only routes a spec that lies
*outside the SoA support set* (a degraded scenario, a predictive
replanner) to the scalar engine.

Not ported yet, and raising :class:`NotImplementedError` that names the
ROADMAP item bringing them: ``backend="auto"`` and ``"lockstep"`` (A3,
the lockstep engine), flight recorders (``spec.record``,
``recorders=``) and ``sweep`` / ``aggregate_sweep`` / ``parallel_map``
(A7, ``obs`` and ``sweeps``).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import abc as _abc
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .._device import resolve_device
from ..core.experiment import ExperimentSpec, build_stack, make_policy
from ..core.runtime import (
    OnlineReplanner,
    PredictiveReplanner,
    SchedulePortfolio,
)
from ..core.sim import SimConfig, Simulator, SimReport
from ..core.sim.batch import sample_trace_batch
from ..core.sim.trace import Trace, build_skeleton, sample_trace
from ..obs import metrics
from .modes import get_mode, register_mode
from .script import ScenarioScript

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
    "sweep",
    "aggregate_sweep",
]

_NO_LOCKSTEP = (
    "the lockstep engine is not ported yet (ROADMAP A3); use "
    "backend='scalar' or backend='soa'"
)
_NO_OBS = (
    "flight recorders are not ported yet (ROADMAP A7: obs); run without "
    "spec.record / recorders="
)
_NO_SWEEPS = "sweeps are not ported yet (ROADMAP A7: sweeps)"


@dataclasses.dataclass
class ScenarioSpec(ExperimentSpec):
    """One scenario run.

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
    #: precompiled per-mode schedules; None compiles one per run
    portfolio: Optional[SchedulePortfolio] = None
    #: mode definitions to (re-)register before running
    mode_defs: Optional[Dict[str, object]] = None
    #: attach a flight recorder (not ported yet: raises when set)
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
        name="soa", kind="distributional", batched=True,
        description=(
            "structure-of-arrays torch backend on the card (ladder grant "
            "as a CUDA kernel); distributionally equivalent to scalar"
        ),
        supports=soa_usable,
    ),
)


def _check_backend(backend: str) -> None:
    if backend in ("auto", "lockstep"):
        raise NotImplementedError(_NO_LOCKSTEP)
    if backend not in SWEEP_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} (choose from {SWEEP_BACKENDS.names()})"
        )


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


def _sim_config(spec: ScenarioSpec, trace: Optional[Trace]) -> SimConfig:
    scen = spec.scenario
    return SimConfig(
        duration_s=(
            scen.duration_s if spec.duration_s is None else spec.duration_s
        ),
        seed=spec.seed,
        drop_policy=spec.drop_policy,
        scenario=scen,
        trace=trace,
    )


# ---------------------------------------------------------------------------
# backend implementations (private; dispatch through run())
# ---------------------------------------------------------------------------
def _run_single(spec: ScenarioSpec, trace: Optional[Trace] = None) -> SimReport:
    """Scalar reference engine: one scenario end-to-end."""
    wf, model, sched, portfolio = _prepare_run(spec)
    policy = _make_run_policy(spec, portfolio)
    return Simulator(wf, model, sched, policy, _sim_config(spec, trace)).run()


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
    backend: str = "soa",
    trace: Optional[Trace] = None,
    recorders=None,
    options=None,
    fallback: bool = True,
    device="cuda",
) -> List[SimReport]:
    """Run scenario simulations; always returns one report per run.

    Three call shapes:

    * ``run(spec)`` — a single drive (``run(spec)[0]`` is the report);
    * ``run(spec, seeds=[...])`` — a Monte-Carlo *seed fan* of one
      spec, one report per seed;
    * ``run([spec_a, spec_b, ...])`` — a *group* of specs, one report
      per spec, in order.

    ``backend`` selects the engine (see :data:`SWEEP_BACKENDS`):

    * ``"soa"`` (default) — the distributional backend on ``device``.
      Specs outside its support set run on the scalar engine when
      ``fallback=True`` or raise ``SoaUnsupported`` when
      ``fallback=False``.
    * ``"scalar"`` — the exact per-event reference engine (host code).

    ``device`` defaults to ``"cuda"`` and is checked first, for every
    backend: without a CUDA device the call raises unless the caller
    passes ``device="cpu"``.

    ``trace`` injects presampled randomness (:func:`build_trace`) into
    scalar runs.  ``options`` passes
    :class:`~repro_torch.core.sim.soa.SoaOptions` to the SoA backend.
    """
    dev = resolve_device(device)
    single = isinstance(specs, ScenarioSpec)
    spec_list: List[ScenarioSpec] = [specs] if single else list(specs)
    _check_backend(backend)
    if recorders or any(s.record for s in spec_list):
        raise NotImplementedError(_NO_OBS)
    if not spec_list:
        return []
    if options is not None and backend != "soa":
        raise ValueError("options= configures the SoA backend; pass backend='soa'")
    if backend == "soa" and trace is not None:
        raise ValueError(
            "the SoA backend materializes its own device trace; "
            "trace= is only valid for the scalar backend"
        )
    if seeds is not None:
        if not single:
            raise ValueError(
                "seeds= fans one spec over Monte-Carlo seeds; pass a "
                "single spec (a list of specs is a group, one run each)"
            )
        if trace is not None:
            raise ValueError(
                "trace= carries one seed's presampled draws; it cannot "
                "be combined with seeds="
            )
        spec = spec_list[0]
        seeds = [int(s) for s in seeds]
        if backend == "soa":
            return _soa_or_fallback(spec, seeds, options, fallback, dev)
        return [_run_single(dataclasses.replace(spec, seed=s)) for s in seeds]
    if backend == "soa":
        return [
            _soa_or_fallback(s, [s.seed], options, fallback, dev)[0]
            for s in spec_list
        ]
    return [_run_single(s, trace) for s in spec_list]


def _soa_or_fallback(spec, seeds, options, fallback, dev) -> List[SimReport]:
    ok, why = soa_usable(spec)
    if ok:
        return _run_soa(spec, seeds, options, dev)
    if not fallback:
        from ..core.sim import soa

        raise soa.SoaUnsupported(why)
    return [_run_single(dataclasses.replace(spec, seed=int(s))) for s in seeds]


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------
def parallel_map(*_args, **_kw):
    """Process-pool map of the reference's sweep service (not ported)."""
    raise NotImplementedError(_NO_SWEEPS)


def sweep(*_args, **_kw):
    """Monte-Carlo sweep over Markov scenarios (not ported)."""
    raise NotImplementedError(_NO_SWEEPS)


def aggregate_sweep(*_args, **_kw):
    """Per-policy aggregation of sweep rows (not ported)."""
    raise NotImplementedError(_NO_SWEEPS)
