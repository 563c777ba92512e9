"""Tile-stream — the event-driven system simulator (paper §V-A).

Models streaming data from periodic sensors, DAG-driven task activation,
scheduler decisions and stop-migrate-restart reallocation stalls at
microsecond granularity; reports per-task progress, resource-occupancy
decomposition (idle / effective / realloc waste) and E2E latency
distributions under the F1/F2 variation factors.
"""
from .engine import (
    ForecastStats,
    Job,
    JobState,
    ModeStats,
    Simulator,
    SimConfig,
    SimReport,
)
from .policy import Policy
from .trace import Trace, build_skeleton, counter_uniforms, sample_trace

__all__ = [
    "ForecastStats",
    "Job",
    "JobState",
    "ModeStats",
    "Simulator",
    "SimConfig",
    "SimReport",
    "Policy",
    "Trace",
    "build_skeleton",
    "counter_uniforms",
    "sample_trace",
]
