"""Self-profiling registry: named counters + phase timers.

The reproduction's own machinery (skeleton build, trace sampling,
portfolio compiles, autotune search, the engine event loop) is what the
performance docs reason about, so it should be measurable without an
external profiler.  This module is a process-global registry of

* **counters** — monotonically increasing named integers/floats
  (``count("skeleton_cache_hit")``), and
* **phase timers** — wall-clock accumulators around named phases
  (``with phase("engine_run"): ...``), recording call count and total
  seconds.

Everything is **disabled by default**: instrumented call sites pay one
module-level boolean check and nothing else, so the hot paths the
registry observes are not perturbed by it (the same
zero-overhead-when-off contract as the engine's
:class:`~h100bench.ref_soa.obs.events.TraceRecorder`).  ``benchmarks/run.py``
enables it for ``--out``/``--trace-out`` runs and exports
:func:`snapshot` as the benchmark JSON's ``profile`` section.

The registry is deliberately not thread-safe and not shared across
``spawn`` pool workers — each process profiles itself; parent-side
snapshots cover the parent's own work (compiles, single runs, the
non-parallel sweep path).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, List

__all__ = [
    "count",
    "enable",
    "enabled",
    "phase",
    "reset",
    "snapshot",
]

_enabled: bool = False
_counters: Dict[str, float] = {}
#: name -> [n_calls, total_seconds]
_phases: Dict[str, List[float]] = {}


def enable(on: bool = True) -> None:
    """Turn the registry on (or off).  Off is the default; call sites
    compiled into hot paths only ever pay the boolean check."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear all counters and timers (the enable flag is untouched)."""
    _counters.clear()
    _phases.clear()


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` (no-op while disabled)."""
    if _enabled:
        _counters[name] = _counters.get(name, 0) + value


@contextmanager
def phase(name: str) -> Iterator[None]:
    """Time a named phase (no-op while disabled).

    Re-entrant in the trivial sense: nested/repeated phases of the same
    name accumulate into one bucket."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        slot = _phases.get(name)
        if slot is None:
            _phases[name] = [1, dt]
        else:
            slot[0] += 1
            slot[1] += dt


def snapshot(reset_after: bool = False) -> Dict[str, object]:
    """A picklable/JSON-able view of everything recorded so far:
    ``{"counters": {name: value}, "phases": {name: {"n", "total_s",
    "mean_s"}}}``."""
    out: Dict[str, object] = {
        "counters": dict(sorted(_counters.items())),
        "phases": {
            name: {
                "n": int(n),
                "total_s": total,
                "mean_s": total / n if n else 0.0,
            }
            for name, (n, total) in sorted(_phases.items())
        },
    }
    if reset_after:
        reset()
    return out
