"""Tp-driven — non-isolated, colocation-aware work-conserving scheduler
(paper §III-A2; Planaria [14] as the representative).

Maintains a deadline-driven task queue; *every* queue change (arrival or
completion) triggers on-the-fly rescheduling that redistributes all
available tiles among ready tasks to keep every tile saturated.  Jobs
are treated as independent, each with its (GHA-derived) sub-deadline.
Reallocation is assumed cheap — the engine charges the real
stop-migrate-restart stall, which is exactly the mismatch the paper
measures (§III-C2).

With the partitioned variant (``pglb``, ablation §V-B2) the same policy
runs independently inside each of the N partitions.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..sim.engine import Job, JobState, Simulator
from ..sim.policy import Policy

__all__ = ["TpDrivenPolicy"]


class TpDrivenPolicy(Policy):
    name = "tp_driven"

    #: on_point ignores "chunk"; let the engine skip those events
    uses_chunk_points = False

    def __init__(self, drop_on_subddl: bool = False):
        #: Fig. 12 'hard' variant: drop a job once its sub-deadline passed
        self.drop_on_subddl = drop_on_subddl
        self._cands: dict = {}

    def setup(self, sim: Simulator) -> None:
        # per-task DoP candidate cache (hot: every reallocation pass
        # walks the candidate ladder for every queued job)
        self._cands = {
            name: t.dop_candidates()
            for name, t in sim.wf.tasks.items() if not t.is_sensor
        }

    # ------------------------------------------------------------------
    def _reallocate(self, sim: Simulator, partition: int, now: float) -> None:
        part = sim.parts[partition]
        if part.stalled:
            return  # decisions resume when the migration completes
        cap = part.capacity
        tf = sim.hw.tile_flops

        running = [sim.jobs[jid] for jid in part.running]
        ready = sim.eligible_jobs(partition, admitted_only=False)
        queue: List[Job] = sorted(
            running + ready, key=lambda j: (j.sub_ddl, j.jid)
        )

        # EDF quota pass: give each job the smallest DoP meeting its
        # deadline; urgent jobs first.
        alloc: Dict[int, int] = {}
        left = cap
        cands_of = self._cands
        for job in queue:
            cands = cands_of[job.task]
            slack = job.sub_ddl - now
            rem = 1.0 - job.progress
            durs = job.duration_ladder(cands, tf)
            pick = 0
            for c, d in zip(cands, durs):
                if c > left:
                    break
                pick = c
                if rem * d <= slack:
                    break
            alloc[job.jid] = pick
            left -= pick

        # work-conserving pass: saturate every tile (§III-A2) by bumping
        # jobs (EDF order) to their next DoP candidates.
        bumped = True
        while left > 0 and bumped:
            bumped = False
            for job in queue:
                cands = cands_of[job.task]
                cur = alloc.get(job.jid, 0)
                for c in cands:  # next candidate above cur (inline: hot)
                    if c > cur:
                        if c - cur <= left:
                            alloc[job.jid] = c
                            left -= c - cur
                            bumped = True
                        break

        resize: Dict[int, int] = {}
        starts: Dict[int, int] = {}
        for job in queue:
            a = alloc.get(job.jid, 0)
            if job.state == JobState.RUNNING:
                if a != job.dop:
                    resize[job.jid] = a  # 0 preempts
            elif a > 0:
                starts[job.jid] = a
        if resize or starts:
            sim.resize(partition, resize, starts)

    # ------------------------------------------------------------------
    def on_point(
        self, sim: Simulator, partition: int, now: float, reason: str,
        job: Optional[Job] = None,
    ) -> None:
        if partition < 0:
            return
        if reason == "timer" and job is not None:
            if job.state not in (JobState.DONE, JobState.DROPPED):
                if self.drop_on_subddl and now >= job.sub_ddl - 1e-12:
                    sim.terminate(job, "subddl_drop")
                elif sim.cfg.drop_policy == "hard" and now >= job.e2e_ddl - 1e-12:
                    sim.terminate(job, "e2e_deadline")
            return
        if reason == "ready" and job is not None:
            if self.drop_on_subddl:
                sim.arm_timer(partition, job.sub_ddl, job)
            elif sim.cfg.drop_policy == "hard":
                sim.arm_timer(partition, job.e2e_ddl, job)
        if reason in ("ready", "finish", "drop", "resume"):
            # every queue change triggers rescheduling (Fig. 3a)
            self._reallocate(sim, partition, now)
