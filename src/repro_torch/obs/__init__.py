"""Observability for the port: phase timers and counters
(:mod:`~repro_torch.obs.metrics`).  The flight recorder, its exporter
and miss attribution are not ported yet."""
from . import metrics

__all__ = ["metrics"]
