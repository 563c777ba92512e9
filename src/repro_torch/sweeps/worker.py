"""Manifest shard worker: ``python -m repro_torch.sweeps.worker``.

One invocation processes one shard of a campaign manifest: it rebuilds
the campaign's cells deterministically from the manifest's embedded
spec, keeps the cell *groups* whose ``scenario_index % num_shards ==
shard`` (groups stay whole so the shared-trace policy pairing is
preserved), skips anything already in the shared result cache, runs
the rest, and writes the rows into the cache.  Workers coordinate
only through the manifest (read-only) and the cache (atomic writes),
so any number of them can run concurrently on one host or — with the
cache on a shared filesystem — across hosts.

The ``--report`` JSON is for the parent
(:class:`~repro_torch.sweeps.executor.SubprocessShardExecutor`) to merge
per-cell outcomes back into the manifest; the cache itself is the
source of truth for rows.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from .._device import resolve_device
from .cache import ResultCache
from .executor import ItemFailure, LocalPoolExecutor
from .manifest import CampaignManifest

__all__ = ["run_shard", "main"]


def run_shard(
    manifest_path,
    cache_dir,
    shard: int = 0,
    num_shards: int = 1,
    jobs: Optional[int] = 1,
    max_groups: Optional[int] = None,
    device: str = "cuda",
) -> Dict[str, object]:
    """Execute this shard's pending cells; return the shard report.

    ``max_groups`` bounds how many scenario groups run (used by tests
    to simulate an interrupted campaign: run a few groups, "crash",
    then resume from the manifest).  ``device`` is where SoA cells
    run; it is resolved first (without a card it must be ``"cpu"``).
    """
    from .service import (
        CampaignSpec,
        _GroupTask,
        _attach_portfolios,
        _run_cell_group,
        build_cells,
    )

    device = str(resolve_device(device))
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} outside 0..{num_shards - 1}")
    manifest = CampaignManifest.load(manifest_path)
    campaign = CampaignSpec.from_dict(manifest.campaign)
    cache = ResultCache(cache_dir)

    cells = build_cells(campaign)
    mine = [
        c for c in cells
        if c.scenario_index % num_shards == shard
        and cache.get(c.key) is None        # full read: corrupt == missing
    ]
    groups: Dict[int, list] = {}
    for c in mine:
        groups.setdefault(c.scenario_index, []).append(c)
    picked = sorted(groups.items())
    if max_groups is not None:
        picked = picked[:max_groups]
    if picked:
        flat = [c for _si, cs in picked for c in cs]
        _attach_portfolios(flat, campaign)
    tasks = [
        _GroupTask(
            specs=[c.spec for c in cs],
            cells=[(c.index, c.key) for c in cs],
            backend=campaign.backend,
            device=device,
        )
        for _si, cs in picked
    ]

    cell_reports: List[Dict[str, object]] = []
    n_executed = n_failed = 0
    for i, outcome in LocalPoolExecutor(jobs).imap(_run_cell_group, tasks):
        if isinstance(outcome, ItemFailure):
            n_failed += len(tasks[i].cells)
            for idx, key in tasks[i].cells:
                cell_reports.append({
                    "index": idx, "key": key, "status": "failed",
                    "error": f"{outcome.error}\n{outcome.traceback}",
                })
            continue
        for entry in outcome:
            if entry[0] == "ok":
                _tag, idx, key, row = entry
                cache.put(key, row)
                n_executed += 1
                cell_reports.append({
                    "index": idx, "key": key, "status": "done",
                    "error": None,
                })
            else:
                _tag, idx, key, err = entry
                n_failed += 1
                cell_reports.append({
                    "index": idx, "key": key, "status": "failed",
                    "error": err,
                })
    return {
        "shard": shard,
        "num_shards": num_shards,
        "n_cells": len(mine),
        "n_executed": n_executed,
        "n_failed": n_failed,
        "cells": cell_reports,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweeps.worker",
        description="run one shard of a sweep-campaign manifest",
    )
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument(
        "--device", default="cuda",
        help="where SoA cells run (default: cuda; cpu without a card)",
    )
    ap.add_argument(
        "--report", default=None,
        help="write the shard report JSON here (default: stdout)",
    )
    args = ap.parse_args(argv)
    report = run_shard(
        args.manifest, args.cache_dir,
        shard=args.shard, num_shards=args.num_shards, jobs=args.jobs,
        device=args.device,
    )
    blob = json.dumps(report, indent=2)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            fh.write(blob)
    else:
        print(blob)
    # per-cell failures are data, not a worker crash: the parent reads
    # them from the report; a nonzero exit is reserved for the worker
    # itself breaking
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
