"""ADS-Tile colocation layer for serving (the TPU adaptation of §IV).

Several models ("tasks") share one accelerator pool.  Jobs (inference
requests, possibly chained model->model like the ADS DAG) are admitted
and prioritised by the same mechanisms as the Tile-stream runtime:

* **elastic reservation** — per-model ERT/sub-deadline from a GHA-style
  offline pass over measured latency profiles; quota control picks the
  cheapest *compiled variant* (the serving analogue of a DoP candidate:
  each model is AOT-compiled at several batch/parallelism variants,
  §IV-D2's ``c_v^compiled``) that meets the job's target;
* **configurable isolation** — models are grouped into partitions; a
  job only ever executes on its partition's executor, so one model's
  burst cannot stall the whole pool;
* **DAG slack sharing** — job targets extend to
  ``e2e_deadline - downstream_budget`` when upstream ran late.

On this CPU container the pool is a single device, so "variants" differ
in batch size rather than chip count — the scheduler logic is identical
and is exactly what ``examples/serve_colocated.py`` demonstrates.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ServedModel", "ColocatedServer", "ServeJob"]


@dataclasses.dataclass
class ServedModel:
    name: str
    #: variant name -> (callable(batch_of_prompts) -> outputs, est_latency_s)
    variants: Dict[str, Tuple[Callable, float]]
    partition: int = 0
    budget_s: float = 0.1             # l_v from the offline pass
    ert_offset_s: float = 0.0         # t_v
    downstream_budget_s: float = 0.0  # for slack sharing

    def cheapest_variant_meeting(self, slack_s: float) -> str:
        """FitQuota over compiled variants: slowest (cheapest) variant
        whose estimated latency fits the slack; fastest otherwise."""
        ordered = sorted(self.variants.items(), key=lambda kv: -kv[1][1])
        for name, (_, lat) in ordered:
            if lat <= slack_s:
                return name
        return ordered[-1][0]


@dataclasses.dataclass(order=True)
class ServeJob:
    sub_deadline_s: float
    seq: int = dataclasses.field(compare=True)
    model: str = dataclasses.field(compare=False, default="")
    payload: object = dataclasses.field(compare=False, default=None)
    arrival_s: float = dataclasses.field(compare=False, default=0.0)
    e2e_deadline_s: float = dataclasses.field(compare=False, default=np.inf)
    ert_s: float = dataclasses.field(compare=False, default=0.0)
    done_cb: Optional[Callable] = dataclasses.field(compare=False, default=None)


class ColocatedServer:
    """Partitioned EDF executor with ERT admission and variant quotas."""

    def __init__(self, models: Dict[str, ServedModel], num_partitions: int = 1):
        self.models = models
        self.parts: Dict[int, List[ServeJob]] = {}
        for m in models.values():
            self.parts.setdefault(m.partition, [])
        self._seq = 0
        self.log: List[Dict] = []

    # ------------------------------------------------------------------
    def submit(self, model: str, payload, deadline_s: Optional[float] = None,
               done_cb: Optional[Callable] = None) -> None:
        m = self.models[model]
        now = time.time()
        self._seq += 1
        e2e = now + deadline_s if deadline_s is not None else np.inf
        job = ServeJob(
            sub_deadline_s=now + m.ert_offset_s + m.budget_s,
            seq=self._seq,
            model=model,
            payload=payload,
            arrival_s=now,
            e2e_deadline_s=e2e,
            ert_s=now + m.ert_offset_s,
            done_cb=done_cb,
        )
        heapq.heappush(self.parts[m.partition], job)

    # ------------------------------------------------------------------
    def _target(self, job: ServeJob) -> float:
        m = self.models[job.model]
        # soft sub-deadline with slack sharing (§IV-C ③)
        return max(job.sub_deadline_s,
                   job.e2e_deadline_s - m.downstream_budget_s)

    def step_partition(self, part: int) -> Optional[Dict]:
        """Run the most urgent admitted job of one partition."""
        q = self.parts.get(part, [])
        now = time.time()
        admitted = [j for j in q if j.ert_s <= now]
        if not admitted:
            return None
        job = min(admitted, key=lambda j: (j.sub_deadline_s, j.seq))
        q.remove(job)
        heapq.heapify(q)

        m = self.models[job.model]
        if now > job.e2e_deadline_s:   # Getddl dequeue (§IV-C)
            rec = {"model": job.model, "dropped": True, "latency_s": None}
            self.log.append(rec)
            return rec
        slack = self._target(job) - now
        variant = m.cheapest_variant_meeting(slack)
        fn, est = m.variants[variant]
        t0 = time.time()
        out = fn(job.payload)
        dt = time.time() - t0
        rec = {
            "model": job.model,
            "variant": variant,
            "est_s": est,
            "actual_s": dt,
            "latency_s": time.time() - job.arrival_s,
            "missed": time.time() > job.e2e_deadline_s,
            "dropped": False,
        }
        self.log.append(rec)
        if job.done_cb:
            job.done_cb(out)
        return rec

    def run(self, duration_s: float) -> List[Dict]:
        end = time.time() + duration_s
        while time.time() < end:
            ran = False
            for part in self.parts:
                if self.step_partition(part) is not None:
                    ran = True
            if not ran:
                if all(not q for q in self.parts.values()):
                    break
                time.sleep(0.001)
        return self.log
