"""Pluggable sweep-cell executors.

The sweep service separates *what* to run (a campaign's cell groups)
from *how* to run it:

* :class:`LocalPoolExecutor` — today's single-host spawn pool
  (``parallel_map`` semantics: order-preserving, ``spawn`` start
  method, degrade-to-serial inside daemonic workers), upgraded with
  per-item **error capture**: one crashing cell no longer aborts the
  whole sweep and discards every completed result.  The scenario
  runner's ``parallel_map`` is now a thin wrapper over this class.
* :class:`SubprocessShardExecutor` — shards a campaign *manifest*
  across independent ``python -m repro_torch.sweeps.worker`` invocations
  that coordinate only through the manifest and the shared result
  cache.  On one host it is a process-isolation harness; pointed at a
  shared filesystem it is the multi-host shape (one invocation per
  host, ``--shard i --num-shards k``).
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "ItemFailure",
    "LocalPoolExecutor",
    "SubprocessShardExecutor",
    "ShardResult",
]


@dataclasses.dataclass
class ItemFailure:
    """One failed work item: the exception (when it survived pickling
    back from the worker), its repr, and the worker-side traceback."""

    index: int
    error: str
    traceback: str
    exception: Optional[BaseException] = None

    def reraise(self) -> "NoReturn":  # type: ignore[name-defined]  # noqa: F821
        if self.exception is not None:
            raise self.exception
        raise RuntimeError(
            f"sweep work item {self.index} failed: {self.error}\n{self.traceback}"
        )


class _Capture:
    """Picklable wrapper turning ``fn(item)`` into a tagged outcome
    tuple, so worker exceptions travel back as data."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable) -> None:
        self.fn = fn

    def __call__(self, item):
        try:
            return ("ok", self.fn(item))
        except BaseException as exc:  # noqa: BLE001 - captured, not hidden
            tb = traceback.format_exc()
            try:  # exceptions normally pickle; fall back to repr-only
                import pickle

                pickle.dumps(exc)
                payload = exc
            except Exception:
                payload = None
            return ("err", payload, repr(exc), tb)


def _resolve_jobs(jobs: Optional[int], n_items: int) -> int:
    if jobs is None:
        jobs = os.cpu_count() or 1
    jobs = min(jobs, n_items)
    if multiprocessing.current_process().daemon:
        # already inside a pool worker (e.g. a sweep launched by
        # ``benchmarks.run --jobs``): daemonic processes cannot spawn
        # children, so degrade to the in-process loop
        jobs = 1
    return jobs


class LocalPoolExecutor:
    """Order-preserving process-pool executor (``spawn`` start method;
    ``fn`` and items must be picklable).  ``jobs`` <= 1 or a single
    item degrades to a plain in-process loop."""

    name = "local-pool"

    def __init__(self, jobs: Optional[int] = None) -> None:
        self.jobs = jobs

    def imap(self, fn: Callable, items: Sequence) -> Iterator[Tuple[int, object]]:
        """Yield ``(index, outcome)`` in item order as results finish;
        ``outcome`` is the return value or an :class:`ItemFailure`.
        Results stream, so a caller can persist/aggregate completed
        items even if a later one fails."""
        items = list(items)
        jobs = _resolve_jobs(self.jobs, len(items))
        capture = _Capture(fn)
        if jobs <= 1 or len(items) <= 1:
            for i, item in enumerate(items):
                yield i, self._decode(i, capture(item))
            return
        # spawn, never fork: forking a process that has initialised
        # CUDA is unsafe
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes=jobs) as pool:
            for i, tagged in enumerate(pool.imap(capture, items)):
                yield i, self._decode(i, tagged)

    @staticmethod
    def _decode(index: int, tagged) -> object:
        if tagged[0] == "ok":
            return tagged[1]
        _tag, exc, err, tb = tagged
        return ItemFailure(index=index, error=err, traceback=tb, exception=exc)

    def map(
        self, fn: Callable, items: Sequence, *, return_errors: bool = False
    ) -> List:
        """``[fn(x) for x in items]`` over the pool.  With
        ``return_errors`` failures come back as :class:`ItemFailure`
        entries in place; without it the first failure re-raises (the
        legacy ``parallel_map`` contract) — but only after the full
        pass, so siblings are not cancelled mid-flight."""
        out = [res for _i, res in self.imap(fn, items)]
        if not return_errors:
            for res in out:
                if isinstance(res, ItemFailure):
                    res.reraise()
        return out


# ---------------------------------------------------------------------------
# manifest-sharding executor (multi-host shape)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardResult:
    """Outcome of one ``repro_torch.sweeps.worker`` invocation."""

    shard: int
    returncode: int
    cells: List[dict]          # [{"key", "index", "status", "error"}, ...]
    stderr: str = ""


class SubprocessShardExecutor:
    """Runs a campaign manifest as ``num_shards`` independent worker
    subprocesses (``python -m repro_torch.sweeps.worker``), each owning the
    pending cell groups whose scenario index hashes to its shard.

    Workers never talk to each other: they read the manifest, write
    result rows into the shared content-addressed cache, and emit a
    shard report the parent merges back into the manifest — exactly
    the coordination model that works when "subprocess" becomes "ssh
    to another host" (shared cache directory, one shard id per host).
    """

    name = "subprocess-shard"

    def __init__(
        self,
        num_shards: int = 2,
        jobs_per_shard: int = 1,
        python: Optional[str] = None,
    ) -> None:
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.jobs_per_shard = jobs_per_shard
        self.python = python or sys.executable

    def run_manifest(
        self, manifest_path, cache_dir, *, timeout: Optional[float] = None,
        device: str = "cuda",
    ) -> List[ShardResult]:
        """Run every shard as its own worker process and collect their
        reports; ``device`` is passed on as the workers' ``--device``."""
        manifest_path = Path(manifest_path)
        results: List[ShardResult] = []
        procs = []
        with tempfile.TemporaryDirectory(prefix="sweep-shards-") as td:
            for shard in range(self.num_shards):
                report = Path(td) / f"shard-{shard}.json"
                cmd = [
                    self.python, "-m", "repro_torch.sweeps.worker",
                    "--manifest", str(manifest_path),
                    "--cache-dir", str(cache_dir),
                    "--shard", str(shard),
                    "--num-shards", str(self.num_shards),
                    "--jobs", str(self.jobs_per_shard),
                    "--report", str(report),
                    "--device", str(device),
                ]
                procs.append((shard, report, subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True,
                )))
            for shard, report, proc in procs:
                _out, err = proc.communicate(timeout=timeout)
                cells: List[dict] = []
                if report.exists():
                    try:
                        cells = json.loads(report.read_text())["cells"]
                    except (ValueError, KeyError):
                        cells = []
                results.append(ShardResult(
                    shard=shard, returncode=proc.returncode,
                    cells=cells, stderr=err or "",
                ))
        return results
