"""ADS-Tile DAG-aware runtime scheduler — Algorithm 2 (paper §IV-C).

Per-partition colocation and allocation under the two bounding
mechanisms:

* configurable isolation — this policy only ever touches its own
  partition's tile pool (the engine enforces it structurally);
* elastic reservation — ERT admission + minimum-quota allocation with
  residual capacity left idle for incoming tasks.

DAG-awareness appears as two forms of sharing (§IV-C):

* *spatial* — admitted jobs of co-active paths share the partition
  pool, allocated in sub-deadline order;
* *temporal* — sub-deadlines are soft references: a delayed job's
  target extends to ``e2e_ddl - downstream_budget`` (slack borrowed
  from adjacent stages while the E2E deadline still permits).

``ChkTrigger`` reschedules running tasks only when the latency benefit
outweighs the stop-migrate-restart cost (§III-D).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..sim.engine import Job, JobState, Simulator
from ..sim.policy import Policy
from .reservation import fit_quota

__all__ = ["AdsTilePolicy"]


class AdsTilePolicy(Policy):
    name = "ads_tile"

    def __init__(
        self,
        admission: bool = True,
        quota_control: bool = True,
        slack_sharing: bool = True,
        realloc_gate: float = 1.0,
    ):
        #: disable flags reproduce the ablation variants (§V-B)
        self.admission = admission
        self.quota_control = quota_control
        self.slack_sharing = slack_sharing
        #: reallocation fires only if benefit > gate * partition stall cost
        self.realloc_gate = realloc_gate
        self._down: Dict[str, float] = {}
        self._cands: Dict[str, tuple] = {}
        self._cmax: Dict[str, int] = {}
        self._cands_src: object = ()

    # ------------------------------------------------------------------
    def setup(self, sim: Simulator) -> None:
        # per-task DoP candidate cache (hot: FitQuota walks the ladder
        # at every scheduling point).  Normally workflow-derived, so it
        # survives re-setups after schedule hot-swaps — predictive
        # replanning re-runs setup() at every stage/commit/revert, and
        # only the schedule-derived state below actually changes.  A
        # table compiled by the tile-budget autotuner with DoP pruning
        # carries its *multi-version candidate set* instead
        # (meta["task_dop_candidates"], §IV-D2: the runtime can only
        # pick among the versions actually compiled), so the ladder
        # follows the installed table across swaps.
        src = sim.schedule.meta.get("task_dop_candidates")
        if src is not self._cands_src or not self._cands:
            if src is not None:
                self._cands = {
                    name: tuple(src.get(name, t.dop_candidates()))
                    for name, t in sim.wf.tasks.items() if not t.is_sensor
                }
            else:
                self._cands = {
                    name: t.dop_candidates()
                    for name, t in sim.wf.tasks.items() if not t.is_sensor
                }
            self._cmax = {name: max(c) for name, c in self._cands.items()}
            self._cands_src = src
        # downstream budget per task: tightest over chains (Getddl's
        # relative-timing data, precomputed offline)
        sched = sim.schedule
        for t in sim.wf.tasks:
            if sim.wf.tasks[t].is_sensor:
                continue
            tight = math.inf
            for chain in sim.wf.chain_for(t):
                i = chain.nodes.index(t)
                after = [
                    n for n in chain.nodes[i + 1:]
                    if not sim.wf.tasks[n].is_sensor
                ]
                s = sum(sched.plans[n].budget_s for n in after)
                tight = min(tight, s)
            self._down[t] = 0.0 if tight is math.inf else tight

    # ------------------------------------------------------------------
    def _target(self, job: Job) -> float:
        """Soft sub-deadline with DAG slack sharing (§IV-C, ③)."""
        if not self.slack_sharing:
            return job.sub_ddl
        eff = job.e2e_ddl - self._down.get(job.task, 0.0)
        return max(job.sub_ddl, eff)

    def _quota(self, sim: Simulator, job: Job, cap: int, now: float) -> int:
        cands = self._cands[job.task]
        if not self.quota_control:
            # degenerate: latency-greedy (largest candidate fitting cap)
            fit = [c for c in cands if c <= cap]
            return max(fit) if fit else 0
        return fit_quota(job, cands, self._target(job), now, sim.hw.tile_flops, cap)

    # ------------------------------------------------------------------
    def _schedule(self, sim: Simulator, partition: int, now: float) -> None:
        """Algorithm 2 body."""
        part = sim.parts[partition]
        if part.stalled:
            return
        tf = sim.hw.tile_flops

        # -- Admission Control: admit by ERT (line 3) -------------------
        ready = sim.eligible_jobs(partition, admitted_only=self.admission)
        running = [sim.jobs[jid] for jid in part.running]

        # -- fast path: start ready jobs on free tiles at their quota
        #    (a job past its target still starts — fit_quota degrades to
        #    the fastest candidate, minimising tardiness).  ``ready``
        #    only shrinks, so one sort serves every restart pass.
        ready.sort(key=lambda j: (j.sub_ddl, j.jid))
        started = True
        while started:
            started = False
            free = part.free()
            for job in ready:
                c = self._quota(sim, job, free, now)
                if c > 0:
                    sim.start_job(job, c)
                    if sim.cfg.drop_policy == "hard":
                        sim.arm_timer(partition, job.e2e_ddl, job)
                    ready.remove(job)
                    started = True
                    break

        # -- ChkTrigger (line 4): is rescheduling of running tasks
        #    worth it? ----------------------------------------------------
        free = part.free()
        blocked = [
            j for j in ready
            if self._quota(sim, j, part.capacity, now) > free
        ]
        at_risk = []
        slack_sharing, down = self.slack_sharing, self._down
        cmax = self._cmax
        for job in running:
            if cmax[job.task] <= job.dop:
                continue  # already at the largest candidate: cannot grow
            # _target() inlined (hot: every running job, every point)
            tgt = job.sub_ddl
            if slack_sharing:
                eff = job.e2e_ddl - down.get(job.task, 0.0)
                if eff > tgt:
                    tgt = eff
            if now + job.remaining(job.dop, tf) > tgt:
                at_risk.append(job)
        if not blocked and not at_risk:
            return

        # -- Quota Control: DDL order with reserved residual capacity ---
        queue: List[Job] = sorted(
            running + ready, key=lambda j: (j.sub_ddl, j.jid)
        )
        cap_left = part.capacity
        want: Dict[int, int] = {}
        for job in queue:
            c = self._quota(sim, job, cap_left, now)
            if job.state == JobState.RUNNING and c == 0:
                c = min(job.dop, cap_left)
            want[job.jid] = c
            cap_left -= c
        # residual cap_left stays idle for incoming tasks (line 13)

        # -- apply with benefit/cost gating ------------------------------
        resize: Dict[int, int] = {}
        starts: Dict[int, int] = {}
        n_running = len(running)
        for job in queue:
            c = want[job.jid]
            if job.state == JobState.RUNNING:
                if c == job.dop or c == 0:
                    continue
                per_tile = sim.wf.tasks[job.task].checkpoint_bytes
                stall = sim.hw.realloc_latency(
                    per_tile * abs(c - job.dop), part.capacity
                )
                if c > job.dop:
                    benefit = job.remaining(job.dop, tf) - job.remaining(c, tf)
                    # the stall freezes every co-located job (§IV-D1)
                    cost = stall * max(1, n_running) * self.realloc_gate
                    if benefit > cost:
                        resize[job.jid] = c
                else:
                    # shrink only when a blocked job needs the tiles
                    if blocked:
                        resize[job.jid] = c
            elif c > 0:
                starts[job.jid] = c

        if resize or starts:
            # verify the start set fits once resizes are applied
            freed = sum(
                part.running[j] - d for j, d in resize.items()
            )
            avail = part.free() + freed
            for jid in sorted(starts, key=lambda j: sim.jobs[j].sub_ddl):
                if starts[jid] > avail:
                    starts.pop(jid)
                else:
                    avail -= starts[jid]
            sim.resize(partition, resize, starts)
            if sim.cfg.drop_policy == "hard":
                for jid in starts:
                    sim.arm_timer(partition, sim.jobs[jid].e2e_ddl, sim.jobs[jid])

    # ------------------------------------------------------------------
    def on_point(
        self, sim: Simulator, partition: int, now: float, reason: str,
        job: Optional[Job] = None,
    ) -> None:
        if partition < 0:
            return
        if reason == "timer" and job is not None:
            # Getddl-driven dequeue: E2E deadline passed (§IV-C)
            if (
                sim.cfg.drop_policy == "hard"
                and job.state not in (JobState.DONE, JobState.DROPPED)
                and now >= job.e2e_ddl - 1e-12
            ):
                sim.terminate(job, "e2e_deadline")
            return
        if reason == "ready" and job is not None and sim.cfg.drop_policy == "hard":
            sim.arm_timer(partition, job.e2e_ddl, job)
        if reason in ("ready", "ert", "finish", "drop", "resume", "chunk"):
            self._schedule(sim, partition, now)
