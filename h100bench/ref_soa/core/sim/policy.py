"""Runtime scheduling policy interface for Tile-stream.

A :class:`Policy` is invoked at *scheduling points* — job data-ready,
ERT reached, job finished, reallocation stall ended, chunk boundary,
or a policy-armed timer — always in the context of one partition
(distributed per-partition control, paper §IV-C).  Policies act through
the simulator's verbs (``start_job`` / ``resize`` / ``terminate``);
the engine owns all accounting (busy / idle / realloc waste).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .engine import Job, Simulator


class Policy:
    """Base class; concrete policies live in ``core/baselines`` and
    ``core/runtime``."""

    name: str = "base"
    #: optional online replanner (``core.runtime.replan.OnlineReplanner``);
    #: attach one to make the policy react to driving-mode switches
    replanner: Optional[object] = None
    #: whether this policy acts on ``chunk`` scheduling points.  The
    #: engine skips chunk-boundary event pushes entirely when False —
    #: an event-loop fast path for policies (Cyc., Tp-driven) whose
    #: ``on_point`` ignores the "chunk" reason, where those events were
    #: pure heap traffic.  Leave True if your policy reschedules at
    #: chunk boundaries (ADS-Tile's ChkTrigger does).
    uses_chunk_points: bool = True

    def setup(self, sim: "Simulator") -> None:
        """Called once before the clock starts."""

    def on_mode_change(self, sim: "Simulator", mode: str, now: float) -> None:
        """Called when the scenario's driving mode switches (the engine
        fires this for every ``mode_change`` event).  The default
        delegates to the attached :attr:`replanner`, if any — pinned
        policies simply keep their offline schedule."""
        if self.replanner is not None:
            self.replanner.on_mode_change(sim, mode, now)

    def on_forecast(self, sim: "Simulator", payload: object, now: float) -> None:
        """Called when a ``forecast`` scheduling point armed via
        ``sim.arm_forecast`` fires.  The default delegates to the
        attached :attr:`replanner` when it understands forecasts (a
        ``PredictiveReplanner`` does; the reactive one ignores them)."""
        rep = self.replanner
        if rep is not None and hasattr(rep, "on_forecast"):
            rep.on_forecast(sim, payload, now)

    def on_degrade(
        self, sim: "Simulator", event: object, begin: bool
    ) -> None:
        """Called when an injected platform degradation begins
        (``begin=True``) or its effect lifts (``begin=False``); the
        engine applies the physical effect (capacity loss, bandwidth
        scaling, dropped frames) *before* this hook.  ``event`` is the
        scenario's degradation object (duck-typed; see
        ``h100bench.ref_soa.scenarios.script.DEGRADATION_TYPES``).  The default
        delegates to the attached :attr:`replanner` when it knows how
        to respond (re-selecting a frontier point against the reduced
        tile budget, then restoring on recovery) — pinned policies ride
        out the event on their offline schedule."""
        rep = self.replanner
        if rep is not None and hasattr(rep, "on_degrade"):
            rep.on_degrade(sim, event, begin)

    def on_point(
        self,
        sim: "Simulator",
        partition: int,
        now: float,
        reason: str,
        job: Optional["Job"] = None,
    ) -> None:
        """Called at every scheduling point of ``partition``.

        ``reason`` in {"ready", "ert", "finish", "resume", "chunk",
        "timer", "drop"}.
        """
        raise NotImplementedError
