"""Observability layer: flight recorder, trace export, miss
attribution, and a self-profiling metrics registry.

This package observes the rest of the reproduction without being
imported by it: the engine holds the recorder behind a duck-typed
``SimConfig.recorder`` slot, and core modules reach only
:mod:`repro_torch.obs.metrics` (which imports nothing from core), so there
are no import cycles and no overhead when nothing is recording.

Entry points:

* :class:`TraceRecorder` — pass as ``SimConfig(recorder=...)`` or use
  ``ScenarioSpec(record=True)``;
* :func:`export_chrome_trace` — Perfetto / ``chrome://tracing`` JSON;
* :func:`attribute_misses` / :func:`attribution_report` — decompose
  each missed chain's lateness (queueing / realloc stall / re-stagger /
  duration tail);
* :mod:`~repro_torch.obs.metrics` — counters + phase timers, exported as the
  benchmark JSON's ``profile`` section.

See ``docs/observability.md`` for the event taxonomy and a Perfetto
walkthrough.
"""
from . import metrics
from .attribution import (
    ChainMiss,
    attribute_misses,
    attribution_report,
    summarize_attribution,
)
from .events import EVENT_KINDS, TraceEvent, TraceRecorder
from .export import chrome_trace, export_chrome_trace
from .schema import SchemaError, validate_trace

__all__ = [
    "EVENT_KINDS",
    "ChainMiss",
    "SchemaError",
    "TraceEvent",
    "TraceRecorder",
    "attribute_misses",
    "attribution_report",
    "chrome_trace",
    "export_chrome_trace",
    "metrics",
    "summarize_attribution",
    "validate_trace",
]
