"""Cyc. — fully-isolated, time-multiplexing scheduler (paper §III-A1).

Static reservation: every task has a fixed tile count (its GHA DoP) and
a reserved slot ``[t_v, t_v + l_v]``.  A job may start only at its slot
(ERT) and is **terminated when it overruns its budget** (hard
sub-deadline), so an overrun never delays other tasks.  Resource
bindings are fully static; rescheduling overhead is zero by
construction.

Cyc.(S) — the elastic variant of the ablation (§V-B1): identical
partitions, tile budgets and DoPs, but ERT/DDL act as *elastic*
references: a job starts as soon as its data (and tiles) are available
and is only abandoned at the E2E deadline — this releases slack along
the chain ("E2E slack sharing") at near-zero rescheduling overhead.
"""
from __future__ import annotations

from typing import Optional

from ..sim.engine import Job, JobState, Simulator
from ..sim.policy import Policy

__all__ = ["CyclicPolicy", "ElasticCyclicPolicy"]


class CyclicPolicy(Policy):
    name = "cyc"

    #: hard per-task budget enforcement
    elastic = False
    #: on_point ignores "chunk"; let the engine skip those events
    uses_chunk_points = False

    def setup(self, sim: Simulator) -> None:
        pass

    # -- helpers -----------------------------------------------------------
    def _try_start(self, sim: Simulator, partition: int) -> None:
        part = sim.parts[partition]
        jobs = sim.eligible_jobs(partition, admitted_only=not self.elastic)
        # reservation-table order: earliest slot first
        for job in sorted(jobs, key=lambda j: (j.ert, j.sub_ddl)):
            if job.plan_dop <= part.free():
                sim.start_job(job, job.plan_dop)
                if not self.elastic:
                    # budget enforcement timer at the sub-deadline
                    sim.arm_timer(partition, job.sub_ddl, job)
                elif sim.cfg.drop_policy == "hard":
                    sim.arm_timer(partition, job.e2e_ddl, job)

    def on_point(
        self, sim: Simulator, partition: int, now: float, reason: str,
        job: Optional[Job] = None,
    ) -> None:
        if partition < 0:
            return
        if reason == "timer" and job is not None:
            if job.state in (JobState.DONE, JobState.DROPPED):
                return
            if not self.elastic:
                # hard budget: overrun -> terminate (paper Fig. 3b)
                if now >= job.sub_ddl - 1e-12:
                    sim.terminate(job, "budget_overrun")
            else:
                if sim.cfg.drop_policy == "hard" and now >= job.e2e_ddl - 1e-12:
                    sim.terminate(job, "e2e_deadline")
            self._try_start(sim, partition)
            return
        if reason in ("ready", "ert", "finish", "drop", "resume"):
            if not self.elastic and reason == "ready" and job is not None:
                # a job whose slot cannot be honoured is dropped at its
                # sub-deadline even if it never starts
                if job.state == JobState.READY:
                    sim.arm_timer(partition, job.sub_ddl, job)
            self._try_start(sim, partition)


class ElasticCyclicPolicy(CyclicPolicy):
    name = "cyc_s"
    elastic = True
