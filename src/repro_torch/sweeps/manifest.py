"""Campaign manifest: durable, resumable record of a sweep campaign.

The manifest is a single JSON document holding the campaign spec
(enough to rebuild every cell deterministically), one record per cell
(content-addressed key, status, cache path, error), and the cache
directory it was run against.  It is the unit of resumption — rerun
the service on a manifest (or on the identical campaign spec) and only
cells whose rows are missing from the cache execute — and the unit of
sharding: ``repro_torch.sweeps.worker`` takes a manifest plus ``--shard
i/k`` and processes its slice.

Statuses: ``pending`` (not attempted), ``cached`` (row served from the
cache without executing), ``done`` (executed this run, row persisted),
``failed`` (executed, raised; ``error`` holds the repr + traceback).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["CellRecord", "CampaignManifest", "MANIFEST_VERSION"]

MANIFEST_VERSION = 1

_STATUSES = ("pending", "cached", "done", "failed")


@dataclasses.dataclass
class CellRecord:
    """One sweep cell's durable state."""

    index: int                 # position in the campaign's cell order
    key: str                   # content-addressed cell key (sha256 hex)
    scenario_index: int
    policy: str
    seed: int
    backend: str               # cache equivalence class ("exact"/"soa")
    status: str = "pending"
    cache_path: Optional[str] = None   # relative to the cache root
    error: Optional[str] = None

    def mark(self, status: str, *, cache_path: Optional[str] = None,
             error: Optional[str] = None) -> None:
        if status not in _STATUSES:
            raise ValueError(f"unknown cell status {status!r}")
        self.status = status
        if cache_path is not None:
            self.cache_path = cache_path
        self.error = error

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "CellRecord":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class CampaignManifest:
    """The resumable on-disk form of one campaign."""

    campaign: Dict[str, object]        # CampaignSpec.to_dict()
    cells: List[CellRecord]
    cache_dir: Optional[str] = None
    version: int = MANIFEST_VERSION

    # -- queries ----------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in _STATUSES}
        for c in self.cells:
            out[c.status] = out.get(c.status, 0) + 1
        return out

    def pending(self) -> List[CellRecord]:
        return [c for c in self.cells if c.status in ("pending", "failed")]

    def failed_keys(self) -> List[str]:
        return [c.key for c in self.cells if c.status == "failed"]

    def by_key(self) -> Dict[str, CellRecord]:
        return {c.key: c for c in self.cells}

    # -- persistence ------------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        return {
            "version": self.version,
            "campaign": self.campaign,
            "cache_dir": self.cache_dir,
            "counts": self.counts(),
            "cells": [c.to_dict() for c in self.cells],
        }

    def save(self, path) -> Path:
        """Atomic write (temp + rename): an interrupted campaign never
        leaves a half-written manifest behind."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = json.dumps(self.to_dict(), indent=2)
        fd, tmp = tempfile.mkstemp(
            dir=str(path.parent), prefix=f".{path.name}-", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def load(cls, path) -> "CampaignManifest":
        with open(path, "r", encoding="utf-8") as fh:
            d = json.load(fh)
        version = int(d.get("version", 0))
        if version > MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {version} is newer than this code "
                f"({MANIFEST_VERSION}); refusing to guess"
            )
        return cls(
            campaign=dict(d["campaign"]),
            cells=[CellRecord.from_dict(c) for c in d["cells"]],
            cache_dir=d.get("cache_dir"),
            version=version,
        )

    @staticmethod
    def is_manifest(d: Dict[str, object]) -> bool:
        """Heuristic for CLI front-ends accepting either a campaign
        spec or a manifest file."""
        return "cells" in d and "campaign" in d
