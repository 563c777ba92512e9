"""Elastic reservation primitives (paper §IV-B2).

* **Admission control** — a task is not eligible for colocation until
  its Earliest-Ready-Time (ERT, ``t_v``); the engine's
  ``eligible_jobs(admitted_only=True)`` implements the filter.
* **Quota control** — ``fit_quota`` selects the *minimum* tile quota
  expected to finish a job before its target, leaving residual tiles
  idle for future urgent arrivals instead of distributing all spare
  tiles (the anti-work-conserving choice that trades a little present
  utilisation for lower future timeout risk).
"""
from __future__ import annotations

from typing import Sequence

from ..sim.engine import Job

__all__ = ["fit_quota", "plan_slack", "most_urgent_plan"]


def plan_slack(plan, e2e_offset_s: float) -> float:
    """Downstream slack a scheduling-table entry leaves a task: the gap
    between its sub-deadline and the tightest E2E deadline offset
    through it (``Workflow.deadline_offset``).  A more demanding regime
    schedules the task to an *earlier* sub-deadline and therefore
    leaves a **larger** slack value — which is why
    :func:`most_urgent_plan` (and schedule blending on top of it) picks
    the maximum."""
    return e2e_offset_s - plan.subdeadline_s


def most_urgent_plan(plans: Sequence, e2e_offset_s: float):
    """The candidate plan with the largest downstream slack — i.e. the
    earliest sub-deadline, the most *urgent* target among the regimes
    on offer.  Earlier candidates win ties, so callers order the list
    by retarget cost (current plan first).  Schedule blending picks
    each task's transition-hedge plan with this."""
    best = plans[0]
    best_slack = plan_slack(best, e2e_offset_s)
    for p in plans[1:]:
        s = plan_slack(p, e2e_offset_s)
        if s > best_slack:
            best, best_slack = p, s
    return best


def fit_quota(
    job: Job,
    candidates: Sequence[int],
    target_t: float,
    now: float,
    tile_flops: float,
    cap: int,
) -> int:
    """FitQuota (Alg. 2 line 11): smallest DoP candidate <= ``cap`` whose
    predicted finish meets ``target_t``; if none meets it, the largest
    candidate that fits ``cap`` (best effort); 0 if nothing fits."""
    slack = target_t - now
    rem = 1.0 - job.progress
    durs = job.duration_ladder(tuple(candidates), tile_flops)
    pick = 0
    for c, d in zip(candidates, durs):
        if c > cap:
            break
        pick = c
        if rem * d <= slack:
            return c
    return pick
