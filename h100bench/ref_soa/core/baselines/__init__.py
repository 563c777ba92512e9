"""Baseline scheduling paradigms adapted to tile-based ADS via GHA
(paper §III-A): the fully-isolated time-multiplexing scheduler (Cyc.)
with its elastic variant Cyc.(S), and the non-isolated colocation-aware
work-conserving scheduler (Tp-driven, Planaria-style)."""
from .cyclic import CyclicPolicy, ElasticCyclicPolicy
from .tpdriven import TpDrivenPolicy

__all__ = ["CyclicPolicy", "ElasticCyclicPolicy", "TpDrivenPolicy"]
