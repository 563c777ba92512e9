"""Driving-scenario subsystem: non-stationary, scriptable workloads.

* :mod:`~repro_torch.scenarios.modes` — a registry of driving modes
  (urban, highway, parking, adverse weather, night), each a transform
  over the per-task latency profiles;
* :mod:`~repro_torch.scenarios.script` — a scenario timeline DSL
  (ordered mode segments, transient bursts, sensor dropouts) plus a
  Markov-chain scenario generator;
* :mod:`~repro_torch.scenarios.runner` — the :func:`run` entry point
  (one spec, a seed fan, or a spec group, over a selectable backend:
  the scalar and lockstep engines on the host, the SoA backend on the
  card) and multiprocessing Monte-Carlo sweeps;
  :mod:`repro_torch.sweeps` layers content-addressed caching and
  resumable campaigns on top.
"""
from .modes import MODES, DrivingMode, get_mode, mode_names, register_mode
from .script import (
    BUNDLED_SCENARIOS,
    DEGRADATION_TYPES,
    BandwidthLoss,
    Burst,
    MarkovScenarioGenerator,
    ModeSegment,
    ScenarioScript,
    SensorDropout,
    SensorDropoutStorm,
    ThermalThrottle,
    TileFault,
    default_generator,
    get_scenario,
)
from .runner import (
    SWEEP_BACKENDS,
    BackendRegistry,
    ItemFailure,
    ScenarioSpec,
    SweepBackend,
    SweepReducer,
    SweepRow,
    aggregate_sweep,
    build_trace,
    compile_portfolio,
    parallel_map,
    run,
    soa_usable,
    summarize,
    sweep,
)

__all__ = [
    "MODES",
    "DrivingMode",
    "get_mode",
    "mode_names",
    "register_mode",
    "BUNDLED_SCENARIOS",
    "DEGRADATION_TYPES",
    "BandwidthLoss",
    "Burst",
    "MarkovScenarioGenerator",
    "ModeSegment",
    "ScenarioScript",
    "SensorDropout",
    "SensorDropoutStorm",
    "ThermalThrottle",
    "TileFault",
    "default_generator",
    "get_scenario",
    "SWEEP_BACKENDS",
    "BackendRegistry",
    "ItemFailure",
    "ScenarioSpec",
    "SweepBackend",
    "SweepReducer",
    "SweepRow",
    "aggregate_sweep",
    "build_trace",
    "compile_portfolio",
    "parallel_map",
    "run",
    "soa_usable",
    "summarize",
    "sweep",
]
