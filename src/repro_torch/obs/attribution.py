"""Deadline-miss attribution: decompose each late chain's lateness.

A violation count says *that* a chain missed; this pass says *why*.
For every chain completion recorded late (``chain_complete`` events
with positive lateness), it walks the **realized critical path**
backward from the sink — at each job, the predecessor whose finish
determined the job's ``ready_t`` — and classifies every instant of the
interval ``[source sample, sink finish]`` into four components:

``realloc_stall``
    the job's partition was inside a stop-migrate-restart stall window
    (recorded by the :class:`~repro_torch.obs.events.TraceRecorder`), whether
    the job was waiting or frozen mid-run;
``restagger``
    admission gating: the job was READY but not yet admitted
    (``now < ert`` — the ERT grid, including hot-swap re-staggering
    onto a new rate regime's release grid), plus the release-alignment
    prefix between the chain's source sample and the critical path's
    first event (a sink gated by its *slowest* input waits there);
``queueing``
    READY and admitted, but the policy had not granted tiles
    (contention inside the partition);
``exec`` (reported as ``duration_tail``)
    the job was actually progressing.  ``duration_tail = exec -
    deadline``: how much of the lateness is pure duration overrun
    (often negative — execution fits the deadline and the wait
    components alone explain the miss).

By construction the components **sum exactly** to the observed
lateness::

    queueing + realloc_stall + restagger + duration_tail == latency - deadline

(up to float addition order; the test pins a 1e-9 tolerance), because
the critical path covers ``[t0, finish]`` gaplessly: a job's
``ready_t`` *is* its critical predecessor's ``finish_t``.

Attribution needs the recorder (for the stall windows) and the
simulator's job list (for the realized timing) — it runs on completed
:class:`~repro_torch.core.sim.engine.Simulator` instances, not on reports.
Chains that *dropped* or starved have no completion to decompose; they
are counted separately (``n_dropped`` from ``chain_drop`` events,
``n_unfinished`` from the report-side starvation accounting).
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from .events import TraceRecorder

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.sim.engine import Simulator

__all__ = [
    "ChainMiss",
    "attribute_misses",
    "attribution_report",
    "summarize_attribution",
]

#: matching the engine's violation comparison (lat > deadline + 1e-12)
_LATE_TOL = 1e-12


@dataclasses.dataclass(frozen=True)
class ChainMiss:
    """One late chain completion, decomposed."""

    chain: str
    sink_jid: int
    t0: float                  # source sample time
    deadline_s: float
    latency_s: float
    lateness_s: float          # latency - deadline (> 0)
    queueing_s: float
    realloc_stall_s: float
    restagger_s: float
    duration_tail_s: float     # exec - deadline (may be negative)
    path: Tuple[int, ...]      # critical-path jids, source first

    @property
    def components(self) -> Dict[str, float]:
        return {
            "queueing": self.queueing_s,
            "realloc_stall": self.realloc_stall_s,
            "restagger": self.restagger_s,
            "duration_tail": self.duration_tail_s,
        }


def _overlap(
    lo: float, hi: float, windows: Sequence[Tuple[float, float]]
) -> float:
    """Length of ``[lo, hi]`` covered by the (ordered, disjoint) stall
    windows."""
    if hi <= lo:
        return 0.0
    total = 0.0
    for a, b in windows:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(hi, b) - max(lo, a)
    return total


def _critical_path(sim: "Simulator", sink_jid: int) -> List[int]:
    """Walk the realized critical path from the sink back to a sensor.

    A job enters READY exactly when its last predecessor finishes, so
    the critical predecessor is the one with the maximal ``finish_t``
    (dropped predecessors carry their drop time there).  Every
    predecessor of a completed sink finished or dropped, so the walk is
    total."""
    preds = getattr(sim, "_obs_preds", None)
    if preds is None:
        preds = {}
        for j in sim.jobs:
            for sid in j.succs:
                preds.setdefault(sid, []).append(j.jid)
        sim._obs_preds = preds  # memo: one inversion serves every chain
    jobs = sim.jobs
    path = [sink_jid]
    cur = sink_jid
    while True:
        ps = preds.get(cur)
        if not ps:
            break
        cur = max(
            ps,
            key=lambda p: (
                jobs[p].finish_t if not math.isnan(jobs[p].finish_t)
                else -math.inf
            ),
        )
        path.append(cur)
    path.reverse()
    return path


def _classify(
    sim: "Simulator",
    rec: TraceRecorder,
    path: Sequence[int],
    t0: float,
) -> Tuple[float, float, float, float]:
    """(queueing, realloc_stall, restagger, exec) over ``[t0, finish]``.

    Each component is computed as a difference of interval lengths, so
    the four telescope exactly to ``finish - t0``."""
    jobs = sim.jobs
    queue = stall = stagger = exec_ = 0.0
    head = jobs[path[0]]
    # release-alignment prefix: the chain's source sampled at t0, but
    # the realized critical path may start at a later-released input;
    # a path head released *before* t0 (a slower sibling sensor) is
    # clipped at t0 so coverage is exactly [t0, finish]
    arrival = head.release if not math.isnan(head.release) else t0
    stagger += max(0.0, arrival - t0)
    prev_finish = max(arrival, t0)
    for jid in path:
        job = jobs[jid]
        a = prev_finish
        fin = job.finish_t
        if math.isnan(fin):
            break  # defensive: cannot happen for a completed sink
        if fin <= a:
            continue  # fully covered by the clip (pre-t0 work)
        if job.is_sensor:
            exec_ += fin - a
            prev_finish = fin
            continue
        windows = rec.stall_windows.get(job.partition, ())
        start = job.start_t
        wait_hi = fin if math.isnan(start) else min(start, fin)
        if wait_hi > a:
            # split the wait at the admission time (ERT gating)
            ert = min(max(job.ert, a), wait_hi)
            pre_stall = _overlap(a, ert, windows)
            post_stall = _overlap(ert, wait_hi, windows)
            stall += pre_stall + post_stall
            stagger += (ert - a) - pre_stall
            queue += (wait_hi - ert) - post_stall
        if not math.isnan(start) and fin > start:
            run_lo = max(start, a)
            run_stall = _overlap(run_lo, fin, windows)
            stall += run_stall
            exec_ += (fin - run_lo) - run_stall
        prev_finish = fin
    return queue, stall, stagger, exec_


def attribute_misses(
    sim: "Simulator", recorder: Optional[TraceRecorder] = None
) -> List[ChainMiss]:
    """Decompose every late chain completion of a finished run.

    ``recorder`` defaults to the run's own ``SimConfig.recorder``;
    raises if neither is available (the stall windows only exist on a
    recording)."""
    rec = recorder if recorder is not None else sim.cfg.recorder
    if rec is None:
        raise ValueError(
            "attribution needs the run's TraceRecorder "
            "(run with SimConfig(recorder=...) / ScenarioSpec(record=True))"
        )
    out: List[ChainMiss] = []
    for e in rec.events:
        if e.kind != "chain_complete":
            continue
        data = e.data or {}
        deadline = float(data.get("deadline_s", math.inf))
        lat = e.value
        lateness = lat - deadline
        if lateness <= _LATE_TOL:
            continue
        t0 = float(data.get("t0", e.t - lat))
        path = _critical_path(sim, e.jid)
        queue, stall, stagger, exec_ = _classify(sim, rec, path, t0)
        out.append(ChainMiss(
            chain=e.chain,
            sink_jid=e.jid,
            t0=t0,
            deadline_s=deadline,
            latency_s=lat,
            lateness_s=lateness,
            queueing_s=queue,
            realloc_stall_s=stall,
            restagger_s=stagger,
            duration_tail_s=exec_ - deadline,
            path=tuple(path),
        ))
    return out


def summarize_attribution(
    misses: Sequence[ChainMiss],
    n_dropped: int = 0,
    n_degraded: int = 0,
) -> Dict[str, object]:
    """Aggregate a run's :class:`ChainMiss` rows into the picklable
    dict surfaced as ``SimReport.attribution`` / ``summarize()`` rows
    (and summed across rows by ``aggregate_sweep``)."""
    comp = {"queueing": 0.0, "realloc_stall": 0.0, "restagger": 0.0,
            "duration_tail": 0.0}
    by_chain: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for m in misses:
        total += m.lateness_s
        ch = by_chain.setdefault(
            m.chain, {"n_late": 0, "lateness_s": 0.0, **{k: 0.0 for k in comp}}
        )
        ch["n_late"] += 1
        ch["lateness_s"] += m.lateness_s
        for k, v in m.components.items():
            comp[k] += v
            ch[k] += v
    worst = max(by_chain, key=lambda c: by_chain[c]["lateness_s"]) \
        if by_chain else None
    return {
        "n_late": len(misses),
        "n_dropped": n_dropped,
        "n_degraded": n_degraded,
        "lateness_s": total,
        "components_s": comp,
        "worst_chain": worst,
        "by_chain": by_chain,
    }


def attribution_report(
    sim: "Simulator", recorder: Optional[TraceRecorder] = None
) -> Dict[str, object]:
    """One-call per-run attribution summary (see
    :func:`summarize_attribution`): late completions decomposed,
    violations without a completion counted alongside."""
    rec = recorder if recorder is not None else sim.cfg.recorder
    misses = attribute_misses(sim, rec)
    n_dropped = sum(1 for e in rec.events if e.kind == "chain_drop")
    n_degraded = sum(
        1 for e in rec.events
        if e.kind == "chain_complete"
        and (e.data or {}).get("violated")
        and e.value <= float((e.data or {}).get("deadline_s", math.inf))
    )
    return summarize_attribution(misses, n_dropped, n_degraded)
