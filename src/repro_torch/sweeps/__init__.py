"""Work-sharded sweep service: content-addressed cell cache, resumable
campaign manifests, pluggable executors, streaming aggregation.

Quick tour (details in ``docs/sweeps.md``):

* :func:`~repro_torch.sweeps.cellkey.cell_key` — content-addressed key of one
  sweep cell (workflow signature + scenario tokens + full config + seed
  + backend class + :data:`~repro_torch.sweeps.cellkey.CONTRACT_VERSION`).
* :class:`~repro_torch.sweeps.cache.ResultCache` — on-disk row store keyed by
  cell keys; repeated sweeps only execute new cells.
* :class:`~repro_torch.sweeps.reduce.SweepReducer` — online per-policy
  aggregation (``update(row)`` / ``result()``);
  ``repro_torch.scenarios.aggregate_sweep`` is now a thin batch wrapper.
* :class:`~repro_torch.sweeps.executor.LocalPoolExecutor` /
  :class:`~repro_torch.sweeps.executor.SubprocessShardExecutor` — how cells
  run: today's spawn pool, or manifest shards across worker processes.
* :class:`~repro_torch.sweeps.manifest.CampaignManifest` — the durable,
  resumable record one campaign leaves behind.
* :func:`~repro_torch.sweeps.service.run_campaign` /
  :class:`~repro_torch.sweeps.service.CampaignSpec` — the service tying it
  together (lazily imported: it pulls in the scenario runner).
"""
from __future__ import annotations

from .cache import ResultCache
from .cellkey import CONTRACT_VERSION, cell_key, key_payload, resolve_backend_class
from .executor import (
    ItemFailure,
    LocalPoolExecutor,
    ShardResult,
    SubprocessShardExecutor,
)
from .manifest import MANIFEST_VERSION, CampaignManifest, CellRecord
from .reduce import SweepReducer
from .rows import SweepRow

__all__ = [
    "CONTRACT_VERSION",
    "MANIFEST_VERSION",
    "CampaignManifest",
    "CampaignResult",
    "CampaignSpec",
    "Cell",
    "CellRecord",
    "ItemFailure",
    "LocalPoolExecutor",
    "ResultCache",
    "ShardResult",
    "SubprocessShardExecutor",
    "SweepFailure",
    "SweepReducer",
    "SweepRow",
    "build_cells",
    "cell_key",
    "key_payload",
    "resolve_backend_class",
    "run_campaign",
    "run_shard",
]

#: symbols resolved lazily (PEP 562): ``service``/``worker`` import the
#: scenario runner, which itself imports this package for SweepRow /
#: SweepReducer — eager imports here would cycle.
_LAZY = {
    "CampaignResult": "service",
    "CampaignSpec": "service",
    "Cell": "service",
    "SweepFailure": "service",
    "build_cells": "service",
    "run_campaign": "service",
    "run_shard": "worker",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(__all__)
