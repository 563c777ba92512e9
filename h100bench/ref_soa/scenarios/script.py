"""Scenario timeline DSL + Markov-chain scenario generator.

A :class:`ScenarioScript` is a deterministic timeline of driving-mode
segments plus two kinds of transients:

* :class:`Burst` — a time window during which sampled workloads are
  scaled on top of the active mode (a traffic wave, a construction
  zone);
* :class:`SensorDropout` — a window during which one sensor produces no
  frames (occlusion, glare, a transport hiccup); downstream jobs run
  degraded exactly as the engine already models dropped predecessors.

Scripts are pure data (hashable, picklable) so a Monte-Carlo sweep can
ship them to worker processes, and the compact text form
``"urban:0.5 highway:1.0 urban:0.5"`` round-trips via :meth:`parse`.

:class:`MarkovScenarioGenerator` samples random scripts from a
mode-transition matrix with per-mode dwell times — the fleet-scale view
where each scenario is one drive.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.latency_model import LatencyModel, TaskLatencyProfile
from ..core.workload import Workflow
from .modes import get_mode

__all__ = [
    "ModeSegment",
    "Burst",
    "SensorDropout",
    "TileFault",
    "ThermalThrottle",
    "SensorDropoutStorm",
    "BandwidthLoss",
    "DEGRADATION_TYPES",
    "ScenarioScript",
    "MarkovScenarioGenerator",
    "default_generator",
    "BUNDLED_SCENARIOS",
    "get_scenario",
]


@dataclasses.dataclass(frozen=True)
class ModeSegment:
    mode: str
    duration_s: float

    def __post_init__(self) -> None:
        if self.duration_s <= 0:
            raise ValueError(f"segment {self.mode}: non-positive duration")


@dataclasses.dataclass(frozen=True)
class Burst:
    """Transient workload spike on top of the active mode."""

    start_s: float
    duration_s: float
    work_scale: float = 1.5
    tasks: Tuple[str, ...] = ()   # empty = every DNN task

    def active(self, task: str, t: float) -> bool:
        if not (self.start_s <= t < self.start_s + self.duration_s):
            return False
        return not self.tasks or task.split("#")[0] in self.tasks


@dataclasses.dataclass(frozen=True)
class SensorDropout:
    """Window during which one sensor produces no frames."""

    sensor: str
    start_s: float
    duration_s: float

    def active(self, sensor: str, t: float) -> bool:
        return (
            sensor == self.sensor
            and self.start_s <= t < self.start_s + self.duration_s
        )


# ---------------------------------------------------------------------------
# platform-degradation events (ROADMAP item 4)
# ---------------------------------------------------------------------------
# Unlike bursts/dropouts (which perturb the *workload*), these degrade
# the *platform* under it.  All four are pure frozen data with a common
# shape — ``kind`` tag, ``start_s``, and an ``end_s(horizon)`` giving
# the instant the platform effect lifts — so the engine can thread them
# through one event seam and account time-to-recover per event
# (docs/degradation.md).


@dataclasses.dataclass(frozen=True)
class TileFault:
    """A partition loses ``k_tiles`` tiles at ``start_s``.

    ``duration_s=None`` models a hard fault (the tiles never come
    back); a float models a recoverable fault (e.g. a tile island
    power-cycled back online).
    """

    start_s: float
    partition: int
    k_tiles: int
    duration_s: Optional[float] = None

    kind = "tile_fault"

    def __post_init__(self) -> None:
        if self.start_s < 0 or self.k_tiles <= 0 or self.partition < 0:
            raise ValueError(f"bad tile fault {self!r}")
        if self.duration_s is not None and self.duration_s <= 0:
            raise ValueError(f"bad tile fault duration {self.duration_s}")

    def end_s(self, horizon: float) -> float:
        if self.duration_s is None:
            return horizon
        return min(self.start_s + self.duration_s, horizon)


@dataclasses.dataclass(frozen=True)
class ThermalThrottle:
    """Thermal throttling: task durations stretch by up to ``scale``.

    The stretch ramps linearly over ``ramp_s`` on the way in and out
    (silicon heats and cools; a step is the ``ramp_s=0`` special case).
    The factor is a deterministic function of release time, applied in
    the trace skeleton exactly like a :class:`Burst` work multiplier —
    so throttled draws stay on the counter-based stream contract.
    """

    start_s: float
    duration_s: float
    scale: float = 1.3
    ramp_s: float = 0.0

    kind = "thermal_throttle"

    def __post_init__(self) -> None:
        if self.start_s < 0 or self.duration_s <= 0 or self.scale < 1.0:
            raise ValueError(f"bad thermal throttle {self!r}")
        if self.ramp_s < 0 or self.ramp_s > self.duration_s / 2:
            raise ValueError(
                f"throttle ramp {self.ramp_s} must fit twice in "
                f"duration {self.duration_s}"
            )

    def end_s(self, horizon: float) -> float:
        return min(self.start_s + self.duration_s, horizon)

    def factor(self, t: float) -> float:
        """Duration multiplier at time ``t`` (trapezoidal profile)."""
        t0, t1 = self.start_s, self.start_s + self.duration_s
        if not (t0 <= t < t1):
            return 1.0
        if self.ramp_s > 0.0:
            rise = min(1.0, (t - t0) / self.ramp_s)
            fall = min(1.0, (t1 - t) / self.ramp_s)
            return 1.0 + (self.scale - 1.0) * min(rise, fall)
        return self.scale


@dataclasses.dataclass(frozen=True)
class SensorDropoutStorm:
    """Random per-frame sensor losses over a window.

    Each release of a matching sensor inside the window is dropped with
    probability ``drop_frac`` — drawn on the dedicated degradation
    stream of the counter contract, so the storm changes no other draw
    of the run.  Contrast :class:`SensorDropout`, which silences one
    sensor completely.
    """

    start_s: float
    duration_s: float
    drop_frac: float = 0.3
    sensors: Tuple[str, ...] = ()   # empty = every sensor

    kind = "sensor_dropout_storm"

    def __post_init__(self) -> None:
        if self.start_s < 0 or self.duration_s <= 0:
            raise ValueError(f"bad dropout storm {self!r}")
        if not (0.0 <= self.drop_frac <= 1.0):
            raise ValueError(f"storm drop_frac {self.drop_frac} not in [0,1]")

    def end_s(self, horizon: float) -> float:
        return min(self.start_s + self.duration_s, horizon)

    def active(self, sensor: str, t: float) -> bool:
        if not (self.start_s <= t < self.start_s + self.duration_s):
            return False
        return not self.sensors or sensor.split("#")[0] in self.sensors


@dataclasses.dataclass(frozen=True)
class BandwidthLoss:
    """Transient loss of a fraction of the migration bandwidth.

    During the window every stop-migrate-restart stall's byte-transfer
    term is charged against ``(1 - frac)`` of the nominal NoC/DRAM
    bandwidth (the fixed decision/hop terms are unaffected).
    """

    start_s: float
    duration_s: float
    frac: float = 0.5

    kind = "bandwidth_loss"

    def __post_init__(self) -> None:
        if self.start_s < 0 or self.duration_s <= 0:
            raise ValueError(f"bad bandwidth loss {self!r}")
        if not (0.0 <= self.frac < 1.0):
            raise ValueError(f"bandwidth loss frac {self.frac} not in [0,1)")

    def end_s(self, horizon: float) -> float:
        return min(self.start_s + self.duration_s, horizon)


#: the degradation event union (kept in one place for isinstance checks)
DEGRADATION_TYPES = (TileFault, ThermalThrottle, SensorDropoutStorm,
                     BandwidthLoss)


@dataclasses.dataclass(frozen=True)
class ScenarioScript:
    """An ordered timeline of mode segments with optional transients."""

    name: str
    segments: Tuple[ModeSegment, ...]
    bursts: Tuple[Burst, ...] = ()
    dropouts: Tuple[SensorDropout, ...] = ()
    #: platform-degradation events (tile faults, thermal throttling,
    #: dropout storms, bandwidth loss) — see docs/degradation.md
    degradations: Tuple[object, ...] = ()

    def __post_init__(self) -> None:
        if not self.segments:
            raise ValueError("scenario needs at least one mode segment")
        for seg in self.segments:
            get_mode(seg.mode)  # fail fast on unknown modes
        for d in self.degradations:
            if not isinstance(d, DEGRADATION_TYPES):
                raise ValueError(
                    f"unknown degradation event {d!r} (want one of "
                    f"{[t.__name__ for t in DEGRADATION_TYPES]})"
                )

    # -- timeline queries -------------------------------------------------
    @property
    def duration_s(self) -> float:
        return sum(s.duration_s for s in self.segments)

    def modes(self) -> Tuple[str, ...]:
        """Distinct modes in order of first appearance."""
        seen: List[str] = []
        for s in self.segments:
            if s.mode not in seen:
                seen.append(s.mode)
        return tuple(seen)

    def boundaries(self) -> List[Tuple[float, str]]:
        """``(start_time, mode)`` per segment; first entry is at t=0."""
        out, t = [], 0.0
        for s in self.segments:
            out.append((t, s.mode))
            t += s.duration_s
        return out

    def mode_at(self, t: float) -> str:
        """Active mode at time ``t`` (clamped to the last segment)."""
        acc = 0.0
        for s in self.segments:
            acc += s.duration_s
            if t < acc:
                return s.mode
        return self.segments[-1].mode

    # -- forecast hooks ---------------------------------------------------
    def next_switch(self, t: float) -> Optional[Tuple[float, str]]:
        """``(switch_time, next_mode)`` for the first mode *change*
        strictly after ``t``, or ``None`` past the last seam.

        This is the route-informed forecast source: a scenario script
        *is* the planned route, so feeding it to a
        :class:`~h100bench.ref_soa.core.runtime.ModeForecaster` as ``timeline``
        models a navigation stack that knows the on-ramp is coming
        (switch times exact, confidence still bounded by the Markov
        structure — routes get re-planned).
        """
        acc = 0.0
        for i, s in enumerate(self.segments[:-1]):
            acc += s.duration_s
            nxt = self.segments[i + 1].mode
            if acc > t + 1e-12 and nxt != s.mode:
                return acc, nxt
        return None

    def empirical_transitions(
        self,
    ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, float]]:
        """``(transitions, mean_dwell_s)`` estimated from the script's
        own segment bigrams — the Markov structure a fleet would learn
        from logged drives of this route.  Modes with no outgoing
        segment get an empty row (absorbing)."""
        trans: Dict[str, Dict[str, float]] = {m: {} for m in self.modes()}
        dwell_sum: Dict[str, float] = {}
        dwell_n: Dict[str, int] = {}
        for i, s in enumerate(self.segments):
            dwell_sum[s.mode] = dwell_sum.get(s.mode, 0.0) + s.duration_s
            dwell_n[s.mode] = dwell_n.get(s.mode, 0) + 1
            if i + 1 < len(self.segments):
                nxt = self.segments[i + 1].mode
                row = trans[s.mode]
                row[nxt] = row.get(nxt, 0.0) + 1.0
        mean_dwell = {m: dwell_sum[m] / dwell_n[m] for m in dwell_sum}
        return trans, mean_dwell

    def forecaster(self, route_informed: bool = True, **kw):
        """A :class:`~h100bench.ref_soa.core.runtime.ModeForecaster` primed with
        this script's empirical Markov structure; ``route_informed``
        additionally pins exact switch times from the timeline."""
        from ..core.runtime.forecast import ModeForecaster

        return ModeForecaster.from_script(
            self, use_timeline=route_informed, **kw
        )

    def burst_scale(self, task: str, t: float) -> float:
        scale = 1.0
        for b in self.bursts:
            if b.active(task, t):
                scale *= b.work_scale
        return scale

    def dropped(self, sensor: str, t: float) -> bool:
        return any(d.active(sensor, t) for d in self.dropouts)

    # -- degradation queries ----------------------------------------------
    @property
    def has_degradations(self) -> bool:
        return bool(self.degradations)

    def throttle_factor(self, t: float) -> float:
        """Deterministic duration multiplier from active throttles."""
        f = 1.0
        for d in self.degradations:
            if isinstance(d, ThermalThrottle):
                f *= d.factor(t)
        return f

    def storm_drop_frac(self, sensor: str, t: float) -> float:
        """Per-frame drop probability at ``(sensor, t)`` — overlapping
        storms compose as independent loss processes."""
        keep = 1.0
        for d in self.degradations:
            if isinstance(d, SensorDropoutStorm) and d.active(sensor, t):
                keep *= 1.0 - d.drop_frac
        return 1.0 - keep

    def bandwidth_scale(self, t: float) -> float:
        """Fraction of nominal migration bandwidth available at ``t``."""
        avail = 1.0
        for d in self.degradations:
            if isinstance(d, BandwidthLoss):
                if d.start_s <= t < d.start_s + d.duration_s:
                    avail *= 1.0 - d.frac
        return avail

    def throttles(self) -> Tuple[ThermalThrottle, ...]:
        """The thermal-throttle events (trace skeleton consumer — the
        core layer duck-types the script, so this accessor keeps it
        from importing the event classes)."""
        return tuple(
            d for d in self.degradations if isinstance(d, ThermalThrottle)
        )

    def storms(self) -> Tuple[SensorDropoutStorm, ...]:
        """The sensor-dropout-storm events (trace sampler consumer)."""
        return tuple(
            d for d in self.degradations if isinstance(d, SensorDropoutStorm)
        )

    def rate_regimes(
        self, wf: Workflow, end_s: float
    ) -> List[Tuple[float, float, Workflow]]:
        """Piecewise-constant sensor-rate timeline: ``(t0, t1, wf_r)``
        spans covering ``[0, max(end_s, script length))``.

        Adjacent segments whose modes agree on every sensor period are
        merged into one regime — a mode switch that touches no rate
        must not re-anchor the sensor timers (and a script with no
        rate-modulating mode collapses to a single regime, reproducing
        the stationary unrolling exactly).  At a regime boundary the
        hardware timers restart: the engine re-unrolls the DAG for
        ``wf_r`` with phase 0 at ``t0``.
        """
        bounds = self.boundaries()
        end = max(end_s, self.duration_s)
        out: List[List[object]] = []   # [t0, t1, wf_r]
        for i, (t0, mode) in enumerate(bounds):
            if t0 >= end - 1e-12:
                break
            t1 = bounds[i + 1][0] if i + 1 < len(bounds) else end
            wf_m = get_mode(mode).transform_workflow(wf)
            if out and out[-1][2].sensor_periods == wf_m.sensor_periods:
                out[-1][1] = t1        # same rates: extend, don't re-anchor
            else:
                out.append([t0, t1, wf_m])
        out[-1][1] = max(out[-1][1], end)
        return [(t0, t1, wf_r) for t0, t1, wf_r in out]

    def modulates_rates(self, wf: Workflow) -> bool:
        """True when any mode switch in the script changes a sensor
        period (i.e. the run needs piecewise re-unrolling)."""
        return len(self.rate_regimes(wf, self.duration_s)) > 1

    def cache_token(self) -> tuple:
        """Hashable identity of everything *structural* this script
        contributes to a simulation: the script itself (segments,
        bursts, dropouts are frozen tuples) plus the sensor-rate
        modulation of each referenced mode as currently registered.
        The trace-skeleton cache keys on this, so re-registering a mode
        with different rates invalidates stale skeletons while profile
        -only changes (which never alter structure) do not."""
        return (
            self,
            tuple(
                (
                    m,
                    tuple(sorted(get_mode(m).sensor_rate_scale.items())),
                    tuple(sorted(get_mode(m).sensor_rate_hz.items())),
                )
                for m in self.modes()
            ),
        )

    def profile_token(self) -> tuple:
        """The mode objects this script samples from, as currently
        registered.  ``DrivingMode`` is a frozen value-compared
        dataclass, so the trace sampler uses this (by equality) to
        notice a mode re-registered with different *profile* transforms
        — which must invalidate cached sampling parameters even though
        the structural :meth:`cache_token` rightly ignores it."""
        return tuple(get_mode(m) for m in self.modes())

    def profiles_for(
        self, model: LatencyModel
    ) -> Dict[str, Dict[str, TaskLatencyProfile]]:
        """Per-mode transformed profile tables (consumed by the engine's
        job constructor)."""
        return {
            m: {
                n: get_mode(m).transform_profile(p)
                for n, p in model.profiles.items()
            }
            for m in self.modes()
        }

    # -- compact text form ------------------------------------------------
    def to_string(self) -> str:
        return " ".join(f"{s.mode}:{s.duration_s:g}" for s in self.segments)

    @classmethod
    def parse(cls, text: str, name: str = "parsed") -> "ScenarioScript":
        """Parse ``"urban:0.5 highway:1.0"`` (commas also accepted)."""
        segs = []
        for tok in text.replace(",", " ").split():
            mode, _, dur = tok.partition(":")
            if not dur:
                raise ValueError(f"bad segment {tok!r}: want mode:seconds")
            segs.append(ModeSegment(mode, float(dur)))
        return cls(name=name, segments=tuple(segs))


# ---------------------------------------------------------------------------
# Markov-chain scenario generation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MarkovScenarioGenerator:
    """Samples random :class:`ScenarioScript`s from a mode-transition
    matrix.

    Dwell time in mode ``m`` is ``mean_dwell_s[m] * U(0.5, 1.5)``
    (bounded, so every sampled scenario exercises several switches);
    with probability ``burst_prob`` a segment carries a workload burst,
    and with ``dropout_prob`` a sensor dropout.  Sampling is fully
    determined by ``seed``.
    """

    transitions: Mapping[str, Mapping[str, float]]
    mean_dwell_s: Mapping[str, float]
    initial: Optional[str] = None          # None = uniform over states
    burst_prob: float = 0.15
    dropout_prob: float = 0.05
    dropout_sensors: Tuple[str, ...] = ("cam_multi", "lidar")

    def sample(self, duration_s: float, seed: int) -> ScenarioScript:
        rng = np.random.RandomState(seed)
        states = sorted(self.transitions)
        mode = self.initial or states[rng.randint(len(states))]
        segs: List[ModeSegment] = []
        bursts: List[Burst] = []
        drops: List[SensorDropout] = []
        t = 0.0
        while t < duration_s - 1e-9:
            dwell = float(self.mean_dwell_s[mode]) * float(rng.uniform(0.5, 1.5))
            dwell = min(dwell, duration_s - t)
            segs.append(ModeSegment(mode, dwell))
            if rng.uniform() < self.burst_prob and dwell > 0.1:
                start = t + float(rng.uniform(0.0, dwell * 0.5))
                bursts.append(Burst(
                    start_s=start,
                    duration_s=float(rng.uniform(0.05, dwell * 0.5)),
                    work_scale=float(rng.uniform(1.3, 2.0)),
                ))
            if rng.uniform() < self.dropout_prob and dwell > 0.1:
                sensor = self.dropout_sensors[
                    rng.randint(len(self.dropout_sensors))
                ]
                start = t + float(rng.uniform(0.0, dwell * 0.5))
                drops.append(SensorDropout(
                    sensor=sensor,
                    start_s=start,
                    duration_s=float(rng.uniform(0.05, 0.2)),
                ))
            t += dwell
            nxt = self.transitions[mode]
            names = sorted(nxt)
            probs = np.asarray([nxt[n] for n in names], dtype=float)
            probs /= probs.sum()
            mode = names[int(rng.choice(len(names), p=probs))]
        # self-transitions extend the dwell rather than splitting the
        # timeline into equal-mode segments
        merged: List[ModeSegment] = []
        for seg in segs:
            if merged and merged[-1].mode == seg.mode:
                merged[-1] = ModeSegment(
                    seg.mode, merged[-1].duration_s + seg.duration_s
                )
            else:
                merged.append(seg)
        return ScenarioScript(
            name=f"markov-{seed}",
            segments=tuple(merged),
            bursts=tuple(bursts),
            dropouts=tuple(drops),
        )


#: plausible drive structure: urban is the hub; weather strikes from
#: urban/highway and clears back; parking only borders urban; rush
#: hour builds out of (and decays back into) ordinary urban traffic.
#: rush_hour upclocks the cameras (30 -> 60 Hz), so random Monte-Carlo
#: drives now exercise sensor-rate churn — piecewise re-unrolling and
#: rate-seam hot-swaps — not just the scripted rate benchmarks.
DEFAULT_TRANSITIONS: Dict[str, Dict[str, float]] = {
    "urban": {"highway": 0.30, "parking": 0.13, "adverse_weather": 0.14,
              "night": 0.09, "rush_hour": 0.12, "urban": 0.22},
    "highway": {"urban": 0.40, "adverse_weather": 0.15, "night": 0.10,
                "rush_hour": 0.05, "highway": 0.30},
    "parking": {"urban": 0.90, "parking": 0.10},
    "adverse_weather": {"urban": 0.50, "highway": 0.30,
                        "adverse_weather": 0.20},
    "night": {"urban": 0.40, "highway": 0.40, "night": 0.20},
    "rush_hour": {"urban": 0.55, "highway": 0.20, "rush_hour": 0.25},
}

DEFAULT_DWELL_S: Dict[str, float] = {
    "urban": 0.8, "highway": 1.0, "parking": 0.5,
    "adverse_weather": 0.7, "night": 0.9, "rush_hour": 0.6,
}


def default_generator(**overrides) -> MarkovScenarioGenerator:
    kw = dict(transitions=DEFAULT_TRANSITIONS, mean_dwell_s=DEFAULT_DWELL_S)
    kw.update(overrides)
    return MarkovScenarioGenerator(**kw)


# ---------------------------------------------------------------------------
# bundled named scenarios (used by tests, benchmarks and the demo)
# ---------------------------------------------------------------------------
BUNDLED_SCENARIOS: Dict[str, ScenarioScript] = {
    # leave the garage into rush-hour traffic, then a downpour: the
    # parking-mode schedule is badly undersized for what follows, which
    # is exactly the case online replanning exists for
    "calm_to_rush": ScenarioScript(
        name="calm_to_rush",
        segments=(
            ModeSegment("parking", 0.4),
            ModeSegment("urban", 0.8),
            ModeSegment("adverse_weather", 0.8),
        ),
    ),
    # a commute: city -> highway -> city with a mid-drive traffic wave
    "commute": ScenarioScript(
        name="commute",
        segments=(
            ModeSegment("urban", 0.6),
            ModeSegment("highway", 0.8),
            ModeSegment("urban", 0.6),
        ),
        bursts=(Burst(start_s=1.6, duration_s=0.2, work_scale=1.6),),
    ),
    # night highway run hitting a storm with a brief camera dropout
    "night_storm": ScenarioScript(
        name="night_storm",
        segments=(
            ModeSegment("night", 0.6),
            ModeSegment("adverse_weather", 0.8),
            ModeSegment("highway", 0.6),
        ),
        dropouts=(SensorDropout("cam_multi", 0.8, 0.15),),
    ),
    # pure rate churn: cameras at 15 Hz before dawn, 30 Hz through the
    # morning, 60 Hz in rush hour — every seam changes the hyper-period,
    # so the engine re-unrolls piecewise and the runtime must swap to a
    # table compiled for the new rates (the figS_rates benchmark)
    "rate_churn": ScenarioScript(
        name="rate_churn",
        segments=(
            ModeSegment("night", 0.6),
            ModeSegment("urban", 0.6),
            ModeSegment("rush_hour", 0.8),
        ),
    ),
    # the platform degrades mid-drive (ROADMAP item 4): a camera glare
    # storm on the on-ramp, then a tile island faults out of the
    # perception partition right as rush-hour load arrives — with the
    # migration bandwidth halved while the island power-cycles — and
    # the silicon throttles thermally on the way out.  figS_degrade
    # compares how the policies ride through it on paired traces.
    "degraded_commute": ScenarioScript(
        name="degraded_commute",
        segments=(
            ModeSegment("urban", 0.6),
            ModeSegment("rush_hour", 0.8),
            ModeSegment("urban", 0.6),
        ),
        degradations=(
            SensorDropoutStorm(start_s=0.3, duration_s=0.2,
                               drop_frac=0.3, sensors=("cam_multi",)),
            TileFault(start_s=0.7, partition=1, k_tiles=8, duration_s=0.5),
            BandwidthLoss(start_s=0.7, duration_s=0.5, frac=0.5),
            ThermalThrottle(start_s=1.3, duration_s=0.4,
                            scale=1.25, ramp_s=0.1),
        ),
    ),
}


def get_scenario(name: str) -> ScenarioScript:
    try:
        return BUNDLED_SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r} (bundled: {sorted(BUNDLED_SCENARIOS)})"
        ) from None
