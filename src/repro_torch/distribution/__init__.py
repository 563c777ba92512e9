"""Distribution layer, the part the port carries: straggler monitoring.
Sharding rules and elastic re-meshing are ROADMAP item A8."""
from .elastic import StragglerMonitor

__all__ = ["StragglerMonitor"]
