"""Driving-mode registry: context-dependent latency-profile transforms.

The paper's premise is that DNN inference time in an ADS varies with the
driving context — up to 3.3x between the mean and the p99 [4] — and the
variation is *mode-structured*: urban vs. highway vs. parking, weather,
illumination and traffic density each shift whole groups of tasks at
once (Liu et al., "Understanding Time Variations of DNN Inference in
Autonomous Driving").  A :class:`DrivingMode` captures one such context
as a transform over :class:`~repro_torch.core.latency_model.TaskLatencyProfile`s:

* ``work_scale`` — multiplier on every DNN task's mean FLOPs (scene
  complexity: number of agents, proposals, occupied voxels);
* ``p99_ratio_scale`` — widens/narrows the execution-variation tail F1;
* ``io_base_scale`` / ``io_rate_scale`` — shift the I/O contention model
  F2 (``rate`` is the M/M/1 service rate, so a scale < 1 makes queuing
  tails *heavier*);
* ``sensor_latency_scale`` — sensor preprocessing cost (e.g. denoising
  in rain, longer exposure at night);
* ``task_work_scale`` — per-task extra multipliers keyed by the *base*
  task name (cockpit replicas ``foo#r2`` inherit ``foo``'s entry);
* ``sensor_rate_scale`` / ``sensor_rate_hz`` — per-sensor *rate*
  modulation (ADS sensors run 10-240 Hz and adapt to context: cameras
  downclock at night for exposure, radar/LiDAR upclocks in rain).
  Rate changes alter the workflow's hyper-period, so the simulator
  re-unrolls the DAG piecewise at every regime boundary.

Modes are registered in a module-level registry so scenario scripts can
reference them by name; :func:`register_mode` adds custom ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

from ..core.latency_model import (
    LatencyModel,
    LogNormal,
    ShiftedExponential,
    TaskLatencyProfile,
)
from ..core.workload import Workflow

__all__ = [
    "DrivingMode",
    "MODES",
    "register_mode",
    "get_mode",
    "mode_names",
]

#: lognormal p99/mean ratios beyond this are unrepresentable (sigma
#: saturates in LogNormal); cap to keep widened tails well-defined
_MAX_P99_RATIO = 8.0


@dataclasses.dataclass(frozen=True)
class DrivingMode:
    """One driving context as a transform over task latency profiles."""

    name: str
    work_scale: float = 1.0
    p99_ratio_scale: float = 1.0
    io_base_scale: float = 1.0
    io_rate_scale: float = 1.0
    sensor_latency_scale: float = 1.0
    task_work_scale: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: per-sensor rate multipliers (2.0 doubles the rate, halving the
    #: period), keyed by base sensor name
    sensor_rate_scale: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: absolute per-sensor rate overrides in Hz; take precedence over
    #: ``sensor_rate_scale``
    sensor_rate_hz: Mapping[str, float] = dataclasses.field(default_factory=dict)
    description: str = ""

    def __post_init__(self) -> None:
        for k, v in {**self.sensor_rate_scale, **self.sensor_rate_hz}.items():
            if v <= 0:
                raise ValueError(f"mode {self.name}: non-positive rate for {k}")

    def _task_scale(self, task: str) -> float:
        base = task.split("#")[0]  # cockpit replicas inherit the base task
        return self.work_scale * float(self.task_work_scale.get(base, 1.0))

    def transform_profile(self, prof: TaskLatencyProfile) -> TaskLatencyProfile:
        """Return ``prof`` re-parameterised for this mode."""
        if prof.is_sensor:
            sl = prof.sensor_latency
            return dataclasses.replace(
                prof,
                sensor_latency=LogNormal(
                    sl.mean * self.sensor_latency_scale, sl.p99_ratio
                ),
            )
        ratio = min(
            max(1.0, prof.work.p99_ratio * self.p99_ratio_scale), _MAX_P99_RATIO
        )
        return dataclasses.replace(
            prof,
            work=LogNormal(prof.work.mean * self._task_scale(prof.name), ratio),
            io=ShiftedExponential(
                prof.io.base * self.io_base_scale,
                prof.io.rate * self.io_rate_scale,
            ),
        )

    def transform_model(self, model: LatencyModel) -> LatencyModel:
        """A new :class:`LatencyModel` with every profile transformed
        (the offline view used to compile this mode's GHA schedule)."""
        return LatencyModel(
            {n: self.transform_profile(p) for n, p in model.profiles.items()},
            model.hw,
        )

    # -- sensor-rate modulation -------------------------------------------
    @property
    def modulates_rates(self) -> bool:
        return bool(self.sensor_rate_scale or self.sensor_rate_hz)

    def sensor_period(self, sensor: str, base_period_s: float) -> float:
        """The period of ``sensor`` under this mode (absolute ``_hz``
        override first, else the base period over ``_scale``)."""
        base = sensor.split("#")[0]
        hz = self.sensor_rate_hz.get(base)
        if hz is not None:
            return 1.0 / hz
        return base_period_s / float(self.sensor_rate_scale.get(base, 1.0))

    def transform_workflow(self, wf: Workflow) -> Workflow:
        """``wf`` re-derived with this mode's sensor rates (returns
        ``wf`` itself when the mode modulates no rate).  The per-mode
        GHA compile consumes this so each mode's reservation table is
        built against its *own* hyper-period.

        Rate keys naming no sensor of ``wf`` raise: a typo'd key would
        otherwise silently modulate nothing.
        """
        if not self.modulates_rates:
            return wf
        known = {s.name.split("#")[0] for s in wf.sensor_tasks}
        unknown = sorted(
            k for k in {**self.sensor_rate_scale, **self.sensor_rate_hz}
            if k not in known
        )
        if unknown:
            raise ValueError(
                f"mode {self.name}: rate modulation for unknown sensor(s) "
                f"{unknown} (workflow sensors: {sorted(known)})"
            )
        return wf.with_sensor_rates({
            s.name: self.sensor_period(s.name, s.period_s)
            for s in wf.sensor_tasks
        })


#: the bundled mode registry (name -> DrivingMode)
MODES: Dict[str, DrivingMode] = {}


def register_mode(mode: DrivingMode, overwrite: bool = False) -> DrivingMode:
    if mode.name in MODES and not overwrite:
        raise ValueError(f"mode {mode.name!r} already registered")
    MODES[mode.name] = mode
    return mode


def get_mode(name: str) -> DrivingMode:
    try:
        return MODES[name]
    except KeyError:
        raise KeyError(
            f"unknown driving mode {name!r} (registered: {sorted(MODES)})"
        ) from None


def mode_names() -> Tuple[str, ...]:
    return tuple(sorted(MODES))


# ---------------------------------------------------------------------------
# bundled modes — scales chosen so the spread across modes reproduces the
# up-to-3.3x context variation the paper cites; per-task overrides follow
# the mode structure of Liu et al. (detection/prediction scale with agent
# density, sensors with weather/illumination).  Rate modulation follows
# the same source: cameras halve their rate at night (exposure), the
# LiDAR/radar group doubles in rain (denser returns needed), rush-hour
# perception upclocks the cameras.
# ---------------------------------------------------------------------------
register_mode(DrivingMode(
    name="urban",
    work_scale=1.30,
    p99_ratio_scale=1.15,
    io_rate_scale=0.80,
    task_work_scale={
        "vis_det": 1.30,      # dense scenes: more proposals
        "traj_pred": 1.50,    # many agents to predict
        "path_plan": 1.50,    # crowded solution space
        "traffic_light": 1.25,
    },
    description="dense traffic, many agents, frequent signals",
))
register_mode(DrivingMode(
    name="highway",
    work_scale=0.85,
    io_rate_scale=1.10,
    task_work_scale={"traffic_light": 0.50, "traj_pred": 0.80},
    description="sparse scenes at speed; light detection, long horizon",
))
register_mode(DrivingMode(
    name="parking",
    work_scale=0.55,
    p99_ratio_scale=0.90,
    io_rate_scale=1.20,
    task_work_scale={"traffic_light": 0.40, "traj_pred": 0.60},
    description="low speed, near-field perception only",
))
register_mode(DrivingMode(
    name="adverse_weather",
    work_scale=1.45,
    p99_ratio_scale=1.30,
    io_base_scale=1.30,
    io_rate_scale=0.60,
    sensor_latency_scale=1.50,
    task_work_scale={"lidar_det": 1.20, "depth_est": 1.20},
    sensor_rate_scale={"lidar": 2.0},       # 10 -> 20 Hz: denser returns
    description="rain/fog: denoising, degraded returns, heavy tails",
))
register_mode(DrivingMode(
    name="night",
    work_scale=1.10,
    p99_ratio_scale=1.15,
    sensor_latency_scale=1.30,
    task_work_scale={"traffic_light": 1.30, "optical_flow": 1.20},
    sensor_rate_scale={"cam_multi": 0.5},   # 30 -> 15 Hz: longer exposure
    description="low light: longer exposure, noisier imagery",
))
register_mode(DrivingMode(
    name="rush_hour",
    work_scale=1.35,
    p99_ratio_scale=1.20,
    io_rate_scale=0.75,
    task_work_scale={
        "vis_det": 1.35,
        "traj_pred": 1.60,
        "path_plan": 1.55,
        "traffic_light": 1.25,
    },
    sensor_rate_scale={"cam_multi": 2.0},   # 30 -> 60 Hz: dense traffic
    description="peak urban density: cameras upclocked, heavy prediction",
))
