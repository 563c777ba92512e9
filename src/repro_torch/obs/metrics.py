"""Self-profiling registry: named counters + phase timers.

The port's own machinery (skeleton build, trace sampling, portfolio
compiles, autotune search, the engine event loop, the SoA round loop)
is what the performance docs reason about, so it should be measurable
without an external profiler.  This module is a process-global registry
of

* **counters** — monotonically increasing named integers/floats
  (``count("skeleton_cache_hit")``), and
* **phase timers** — wall-clock accumulators around named phases
  (``with phase("engine_run"): ...``), recording call count and total
  seconds; :func:`phase_seq` times consecutive phases that tile a
  stretch of code, one clock reading per boundary, and
  :func:`active_seq` hands it to the code it calls.

The contract:

* **off** (the default): instrumented call sites pay one module-level
  boolean check and nothing else, so the hot paths the registry
  observes are not perturbed by it (the same zero-overhead-when-off
  contract as the engine's :class:`~repro_torch.obs.events.TraceRecorder`);
* **on**: phases and counters accumulate (aggregates only: calls and
  total seconds, no list of intervals);
* **on while a ``torch.profiler`` is recording**: each phase is also a
  profiler range ``span:<name>`` for its duration, on the profiler's
  clock beside the device's kernels, so a device trace can name the
  phase the host was in during each idle gap.  A phase entered before
  the profiler started opens no range.

The package never enables it itself; the callers that measure do —
``h100bench/systems/soa.py`` for a ``--trace 1`` run of the SoA cells
(its readers under ``h100bench/layers/`` read :func:`snapshot`), and
``chip_smoke.py``'s SoA phases.

The registry is deliberately not thread-safe and not shared across
``spawn`` pool workers — each process profiles itself; parent-side
snapshots cover the parent's own work (compiles, single runs, the
non-parallel sweep path).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch

__all__ = [
    "PhaseSeq",
    "active_seq",
    "count",
    "enable",
    "enabled",
    "phase",
    "phase_seq",
    "reset",
    "snapshot",
]

_enabled: bool = False
_counters: Dict[str, float] = {}
#: name -> [n_calls, total_seconds]
_phases: Dict[str, List[float]] = {}
#: the innermost open :func:`phase_seq`'s sequence
_seq: Optional["PhaseSeq"] = None


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


def _add(name: str, dt: float) -> None:
    slot = _phases.get(name)
    if slot is None:
        _phases[name] = [1, dt]
    else:
        slot[0] += 1
        slot[1] += dt


def _range(name: str):
    """The profiler range ``span:<name>``, entered, while a profiler
    records; else None."""
    if not torch._C._autograd._profiler_enabled():
        return None
    r = torch.profiler.record_function(f"span:{name}")
    r.__enter__()
    return r


@contextmanager
def phase(name: str) -> Iterator[None]:
    """Time a named phase (no-op while disabled).

    Re-entrant in the trivial sense: nested/repeated phases of the same
    name accumulate into one bucket."""
    if not _enabled:
        yield
        return
    rng = _range(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _add(name, time.perf_counter() - t0)
        if rng is not None:
            rng.__exit__(None, None, None)


class PhaseSeq:
    """Consecutive phases with no gap between them: :meth:`enter` ends
    the phase open before it and starts ``name`` on the same clock
    reading; :meth:`close` ends the last one.  :func:`phase_seq` gives
    one while the registry is on."""

    __slots__ = ("_name", "_t0", "_rng")

    def __init__(self) -> None:
        self._name: Optional[str] = None
        self._t0 = 0.0
        self._rng = None

    def _end(self, t: float) -> None:
        if self._name is not None:
            _add(self._name, t - self._t0)
        if self._rng is not None:
            self._rng.__exit__(None, None, None)
            self._rng = None

    def enter(self, name: str) -> None:
        t = time.perf_counter()
        self._end(t)
        self._name, self._t0 = name, t
        self._rng = _range(name)

    def close(self) -> None:
        self._end(time.perf_counter())
        self._name = None


@contextmanager
def phase_seq() -> Iterator[Optional[PhaseSeq]]:
    """A :class:`PhaseSeq` closed on exit, or None while the registry is
    off: a loop caches the answer once and pays one check per step.
    While it is open, :func:`active_seq` returns it."""
    global _seq
    if not _enabled:
        yield None
        return
    seq = PhaseSeq()
    prev, _seq = _seq, seq
    try:
        yield seq
    finally:
        _seq = prev
        seq.close()


def active_seq() -> Optional[PhaseSeq]:
    """The sequence of the innermost open :func:`phase_seq`, or None."""
    return _seq


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
