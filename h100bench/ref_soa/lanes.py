"""Run sampled SoA lanes again through the frozen event-driven engine.

Each lane is one seed of the scenario, simulated on its own by the
scalar Simulator (``core/sim/engine.py``): an event heap in continuous
time, the engine the program's SoA round loop approximates.  Its draws
come from the per-seed NumPy sampler (``core/sim/trace.py``
``sample_trace``), not the batched sampler the program runs.
``draws_dtype`` rounds the draws the engine consumes to a lower
precision: the control that the comparison has to reject.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.experiment import ExperimentSpec, build_stack, make_policy
from .core.runtime import OnlineReplanner, SchedulePortfolio
from .core.sim import SimConfig, Simulator
from .core.sim.trace import build_skeleton, sample_trace
from .scenarios import get_mode, get_scenario

__all__ = ["DRAW_FIELDS", "reference_lanes"]

DRAW_FIELDS = ("work", "io", "sensor_lat")


def _rounded(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float64)).to(dtype).double().numpy()


def reference_lanes(scenario: str, policy: str, cockpit_replicas: int,
                    seeds: Sequence[int], *, drop_policy: str = "soft",
                    duration_s: Optional[float] = None,
                    draws_dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
    """Reports and draws of ``seeds``, each lane on its own; returns
    ``{"reports": [SimReport per seed], "draws": {field: (len(seeds),
    n_jobs) float64}}`` with the draws the engine consumed."""
    scen = get_scenario(scenario)
    spec = ExperimentSpec(policy=policy, cockpit_replicas=cockpit_replicas,
                          drop_policy=drop_policy)
    wf, _hw, model, compiler = build_stack(spec)
    portfolio = SchedulePortfolio.compile(
        model, wf, {m: get_mode(m) for m in scen.modes()}, compiler,
        target_miss=None, harmonize_partitions=True,
    )
    sched = portfolio.schedules[scen.segments[0].mode]
    duration = scen.duration_s if duration_s is None else float(duration_s)
    skel = build_skeleton(wf, scen, duration)
    reports: List = []
    draws: Dict[str, list] = {f: [] for f in DRAW_FIELDS}
    for s in seeds:
        trace = sample_trace(skel, model, scen, int(s))
        if draws_dtype is not None:
            trace = dataclasses.replace(trace, **{
                f: _rounded(getattr(trace, f), draws_dtype) for f in DRAW_FIELDS})
        for f in DRAW_FIELDS:
            draws[f].append(np.asarray(getattr(trace, f), np.float64))
        pol = make_policy(policy)
        pol.replanner = OnlineReplanner(portfolio, detection_delay_s=0.0)
        sim = Simulator(wf, model, sched, pol, SimConfig(
            duration_s=duration, seed=int(s), drop_policy=drop_policy,
            scenario=scen, trace=trace))
        reports.append(sim.run())
    return {"reports": reports, "draws": {f: np.stack(v) for f, v in draws.items()}}
