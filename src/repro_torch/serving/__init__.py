"""Serving substrate: continuous-batching engine per model plus the
ADS-Tile colocation layer that schedules several models on one
accelerator pool under E2E deadlines."""
from .request import Request, RequestState
from .engine import ServingEngine, EngineConfig
from .colocated import ColocatedServer, ServedModel

__all__ = [
    "Request",
    "RequestState",
    "ServingEngine",
    "EngineConfig",
    "ColocatedServer",
    "ServedModel",
]
