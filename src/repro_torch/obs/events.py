"""Flight-recorder event rows + the zero-overhead-when-off recorder.

The engine's accounting (``SimReport``) is all *aggregates*; this
module records the *timeline*: typed, append-only event rows for every
job lifecycle transition, every partition stall, every table swap and
every forecast, so a run can be replayed, visualized
(:mod:`~repro_torch.obs.export`) and decomposed
(:mod:`~repro_torch.obs.attribution`) after the fact.

Design constraints, in order:

1. **Zero overhead when off.**  The engine holds ``self._rec``
   (``SimConfig.recorder``, default ``None``) and every hook site is a
   single ``if rec is not None`` guard — a recorder-less run executes
   the exact same arithmetic as before the hooks existed, and
   pinned-seed reports stay bit-identical (pinned by
   ``tests/test_obs.py``).
2. **Append-only typed rows.**  One frozen :class:`TraceEvent` per
   occurrence; the recorder never mutates or reorders past rows.  Rows
   carry simulation time in seconds, a kind from :data:`EVENT_KINDS`,
   and whichever of jid/task/partition/chain apply (sentinels
   otherwise), so downstream passes need no engine internals.
3. **Cheap enabled path.**  ``emit`` is one dataclass construction and
   a list append; per-partition stall windows are additionally indexed
   on the fly (they are the one thing the attribution pass needs in
   interval rather than event form).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["EVENT_KINDS", "TraceEvent", "TraceRecorder"]


#: the event taxonomy (docs/observability.md documents each kind)
EVENT_KINDS = frozenset({
    # job lifecycle
    "job_release",      # sensor frame released by its hardware timer
    "job_ready",        # DNN job's inputs arrived (deps drained)
    "job_start",        # tiles granted; value = DoP
    "job_chunk",        # chunk-boundary scheduling point
    "job_resize",       # DoP changed mid-run; value = new DoP
    "job_preempt",      # running job pushed back to READY; value = freed DoP
    "job_finish",       # completion; value = DoP held at finish
    "job_drop",         # terminated (deadline dequeue / sensor dropout)
    # chain accounting
    "chain_complete",   # sink finished; value = E2E latency (s)
    "deadline_miss",    # completed late; value = lateness (s)
    "chain_drop",       # sink dropped: a violation with no completion
    # partition / reallocation
    "stall_begin",      # stop-migrate-restart stall opens; value = stall (s)
    "stall_end",        # partition resumes
    "realloc",          # DoP reallocation applied; value = bytes moved
    "hotswap",          # schedule table installed; value = summed stall (s)
    "prestage",         # background staging window; value = bytes staged
    # degraded operation (docs/degradation.md)
    "degrade_begin",    # injected platform event applies; info = kind
    "degrade_end",      # its effect lifts; info = kind
    "morph",            # online partition split/merge; value = new count
    # control plane
    "mode_change",      # driving-context switch; info = new mode
    "rate_seam",        # sensor-rate regime boundary; value = hyper-period
    "forecast_arm",     # forecast scheduling point armed; value = fire time
    "forecast_fire",    # armed forecast delivered to the policy
    "drain_arm",        # drain watch armed
    "drain_clear",      # drain watch cleared
    "schedule",         # initial table metadata; value = peak tiles
})


@dataclasses.dataclass(frozen=True, slots=True)
class TraceEvent:
    """One recorded occurrence.  ``t`` is simulation seconds; unused
    reference fields hold sentinels (``jid=-1``, ``partition=-1``,
    empty strings, ``data=None``)."""

    t: float
    kind: str
    jid: int = -1
    task: str = ""
    partition: int = -1
    chain: str = ""
    value: float = 0.0
    info: str = ""
    data: Optional[dict] = None


class TraceRecorder:
    """Append-only flight recorder for one simulation run.

    Pass one as ``SimConfig(recorder=...)`` (or
    ``ScenarioSpec(record=True)`` to have the runner create it).  A
    recorder is single-run: reusing one across Simulators interleaves
    their timelines.
    """

    __slots__ = ("events", "meta", "stall_windows", "_open_stalls", "end_s")

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        #: run metadata filled by the engine at ``run()`` start
        #: (tiles, partition capacities, policy, seed, horizon)
        self.meta: Dict[str, object] = {}
        #: partition -> closed [begin, end] stall intervals, in order
        self.stall_windows: Dict[int, List[Tuple[float, float]]] = {}
        self._open_stalls: Dict[int, float] = {}
        #: horizon the run drained to; set by :meth:`finalize`
        self.end_s: Optional[float] = None

    # -- recording (engine-facing; the hot path) -----------------------
    def emit(
        self,
        t: float,
        kind: str,
        jid: int = -1,
        task: str = "",
        partition: int = -1,
        chain: str = "",
        value: float = 0.0,
        info: str = "",
        data: Optional[dict] = None,
    ) -> None:
        self.events.append(
            TraceEvent(t, kind, jid, task, partition, chain, value, info, data)
        )

    def stall_begin(self, partition: int, t: float) -> None:
        """Open (or extend) the stall window of ``partition``.  The
        engine may re-stall an already stalled partition (a hot-swap on
        top of a resize extends ``stall_end``); the window keeps the
        earliest begin and closes at the real resume."""
        if partition not in self._open_stalls:
            self._open_stalls[partition] = t

    def stall_end(self, partition: int, t: float) -> None:
        t0 = self._open_stalls.pop(partition, None)
        if t0 is not None:
            self.stall_windows.setdefault(partition, []).append((t0, t))

    def finalize(self, end_s: float) -> None:
        """Close the recording at the horizon: open stall windows are
        clipped to ``end_s`` (a run can end mid-stall)."""
        for p in list(self._open_stalls):
            self.stall_end(p, end_s)
        self.end_s = end_s

    # -- reading (exporter/attribution-facing) -------------------------
    def by_kind(self, kind: str) -> Iterator[TraceEvent]:
        return (e for e in self.events if e.kind == kind)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.events)
