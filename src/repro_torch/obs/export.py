"""Chrome-trace / Perfetto JSON exporter for recorded runs.

Turns a :class:`~repro_torch.obs.events.TraceRecorder` into the Trace Event
Format consumed by ``chrome://tracing`` and https://ui.perfetto.dev —
the run becomes a scrollable timeline instead of a scalar report:

* **one track group per partition** — jobs are laid out on tile
  *lanes* (greedy interval coloring, so concurrent jobs of one
  partition stack instead of overlap), with a dedicated ``stalls``
  lane rendering every stop-migrate-restart window as a slice;
* **sensor tracks** — one per sensor, slices from release to frame
  delivery;
* **counter tracks** — per-partition allocated tiles, cumulative
  reallocation bytes, and the active table's reserved peak tiles;
* **flow events** — each E2E chain completion links its source sensor
  slice to its sink slice, so deadline chains render as arrows
  threading across the swap stalls (violated chains are flagged in
  ``args``);
* **instant markers** — mode changes, rate seams, hot-swaps,
  pre-stage windows, forecast arm/fire, drain watch.

Timestamps are microseconds (the format's unit); simulation second 0
maps to ts 0.  The export validates against the checked-in
``trace_schema.json`` (see :mod:`~repro_torch.obs.schema`).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .events import TraceRecorder

__all__ = ["chrome_trace", "export_chrome_trace"]

_US = 1e6
_PID = 1
#: tid layout: small fixed tids for marker tracks, one block of 10 for
#: sensor tracks, one block of 100 per partition (stall lane + job lanes)
_TID_CONTEXT = 1
_TID_RUNTIME = 2
_TID_SENSOR0 = 10
_PART_BLOCK = 100


def _part_base(p: int) -> int:
    return _PART_BLOCK * (p + 1)


def _assign_lanes(
    slices: List[dict], base_tid: int, max_lanes: int = 64
) -> None:
    """Greedy interval coloring: place each slice (sorted by start) on
    the first lane whose previous slice has ended.  Mutates ``tid`` in
    place."""
    lanes: List[float] = []
    for s in sorted(slices, key=lambda s: (s["_t0"], s["_t1"])):
        lane = None
        for i, end in enumerate(lanes):
            if end <= s["_t0"] + 1e-12:
                lane = i
                break
        if lane is None:
            if len(lanes) < max_lanes:
                lanes.append(0.0)
                lane = len(lanes) - 1
            else:  # saturated: stack on the last lane rather than drop
                lane = len(lanes) - 1
        lanes[lane] = s["_t1"]
        s["tid"] = base_tid + 1 + lane


def chrome_trace(recorder: TraceRecorder) -> dict:
    """Build the Trace Event Format object for one recorded run."""
    events = recorder.events
    end_s = recorder.end_s
    if end_s is None:
        end_s = max((e.t for e in events), default=0.0)

    out: List[dict] = []
    meta_rows: List[dict] = []

    def thread_meta(tid: int, name: str, sort: int) -> None:
        meta_rows.append({
            "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
            "args": {"name": name},
        })
        meta_rows.append({
            "ph": "M", "name": "thread_sort_index", "pid": _PID, "tid": tid,
            "args": {"sort_index": sort},
        })

    meta_rows.append({
        "ph": "M", "name": "process_name", "pid": _PID,
        "args": {"name": "tile-stream run"},
    })
    thread_meta(_TID_CONTEXT, "context (modes / rate seams)", 0)
    thread_meta(_TID_RUNTIME, "runtime (swaps / forecasts)", 1)

    # ------------------------------------------------------------------
    # job slices (open on start, close on finish/drop, clip at horizon)
    # ------------------------------------------------------------------
    open_jobs: Dict[int, dict] = {}
    slices: List[dict] = []
    sensor_tasks: List[str] = []

    def close(jid: int, t1: float, dropped: bool) -> None:
        s = open_jobs.pop(jid, None)
        if s is None:
            return
        s["_t1"] = max(t1, s["_t0"])
        if dropped:
            s["args"]["dropped"] = True
        slices.append(s)

    # per-partition allocation / cumulative realloc-byte counters,
    # emitted while walking the event stream once
    alloc: Dict[int, int] = {}
    rbytes: Dict[int, float] = {}
    reserved = 0.0

    def counter(t: float, name: str, value: float) -> None:
        out.append({
            "ph": "C", "name": name, "pid": _PID, "tid": 0,
            "ts": t * _US, "args": {"value": value},
        })

    def bump_alloc(t: float, p: int, delta: float) -> None:
        if p < 0 or not delta:
            return
        alloc[p] = alloc.get(p, 0) + int(delta)
        counter(t, f"tiles alloc p{p}", alloc[p])

    def bump_bytes(t: float, p: int, nbytes: float) -> None:
        if p < 0 or nbytes <= 0:
            return
        rbytes[p] = rbytes.get(p, 0.0) + nbytes
        counter(t, f"realloc bytes p{p}", rbytes[p])

    def instant(t: float, tid: int, name: str, args: Optional[dict] = None,
                scope: str = "t") -> None:
        row = {
            "ph": "i", "name": name, "pid": _PID, "tid": tid,
            "ts": t * _US, "s": scope,
        }
        if args:
            row["args"] = args
        out.append(row)

    chain_completes: List = []
    for e in events:
        k = e.kind
        if k == "job_start" or k == "job_release":
            open_jobs[e.jid] = {
                "ph": "X", "name": e.task, "pid": _PID, "cat": "job",
                "_t0": e.t, "_t1": e.t, "_part": e.partition,
                "args": {"jid": e.jid, "dop": int(e.value)},
            }
            if k == "job_release" and e.task not in sensor_tasks:
                sensor_tasks.append(e.task)
            bump_alloc(e.t, e.partition, e.value)
        elif k == "job_finish":
            close(e.jid, e.t, dropped=False)
            bump_alloc(e.t, e.partition, -e.value)
        elif k == "job_drop":
            close(e.jid, e.t, dropped=True)
            bump_alloc(e.t, e.partition, -e.value)
        elif k == "job_preempt":
            close(e.jid, e.t, dropped=False)
            bump_alloc(e.t, e.partition, -e.value)
        elif k == "job_resize":
            s = open_jobs.get(e.jid)
            old = float((e.data or {}).get("old", 0))
            if s is not None:
                s["args"]["dop"] = int(e.value)
                s["args"]["resizes"] = s["args"].get("resizes", 0) + 1
                if e.value == 0:  # preempted back to READY by a resize
                    close(e.jid, e.t, dropped=False)
            bump_alloc(e.t, e.partition, e.value - old)
        elif k == "stall_begin":
            bump_bytes(e.t, e.partition, float((e.data or {}).get("bytes", 0)))
        elif k == "prestage":
            for p, nb in ((e.data or {}).get("per_partition") or {}).items():
                bump_bytes(e.t, int(p), float(nb))
            instant(e.t, _TID_RUNTIME, f"prestage {e.value:.0f}B",
                    {"bytes": e.value, **(e.data or {})})
        elif k == "hotswap":
            reserved = float((e.data or {}).get("peak_tiles", reserved))
            counter(e.t, "tiles reserved", reserved)
            instant(e.t, _TID_RUNTIME, f"hotswap:{e.info or 'table'}",
                    {"stall_s": e.value, **(e.data or {})})
        elif k == "schedule":
            reserved = e.value
            counter(e.t, "tiles reserved", reserved)
        elif k == "mode_change":
            instant(e.t, _TID_CONTEXT, f"mode:{e.info}", scope="g")
        elif k == "rate_seam":
            instant(e.t, _TID_CONTEXT, "rate seam",
                    {"hyper_period_s": e.value}, scope="g")
        elif k == "forecast_arm":
            instant(e.t, _TID_RUNTIME, "forecast armed", {"fire_t": e.value})
        elif k == "forecast_fire":
            instant(e.t, _TID_RUNTIME, "forecast fired")
        elif k == "drain_arm":
            instant(e.t, _TID_RUNTIME, "drain watch armed")
        elif k == "drain_clear":
            instant(e.t, _TID_RUNTIME, "drain watch cleared")
        elif k == "chain_complete":
            chain_completes.append(e)
    for jid in list(open_jobs):
        close(jid, end_s, dropped=False)

    # ------------------------------------------------------------------
    # lane layout: sensors by task, partitions by block
    # ------------------------------------------------------------------
    sensor_tid = {t: _TID_SENSOR0 + i for i, t in enumerate(sorted(sensor_tasks))}
    for t, tid in sorted(sensor_tid.items()):
        thread_meta(tid, f"sensor {t}", tid)
    by_part: Dict[int, List[dict]] = {}
    for s in slices:
        p = s.pop("_part")
        if p < 0:
            s["tid"] = sensor_tid.get(s["name"], _TID_SENSOR0)
        else:
            by_part.setdefault(p, []).append(s)
    for p, group in sorted(by_part.items()):
        base = _part_base(p)
        _assign_lanes(group, base)
        n_lanes = max(s["tid"] - base for s in group)
        thread_meta(base, f"partition {p} stalls", base)
        for k in range(1, n_lanes + 1):
            thread_meta(base + k, f"partition {p} lane {k - 1}", base + k)

    slice_of: Dict[int, dict] = {}
    for s in slices:
        t0, t1 = s.pop("_t0"), s.pop("_t1")
        s["ts"] = t0 * _US
        s["dur"] = max(t1 - t0, 0.0) * _US
        slice_of[s["args"]["jid"]] = s
        out.append(s)

    # stall windows as slices on each partition's stall lane
    for p, windows in sorted(recorder.stall_windows.items()):
        base = _part_base(p)
        if p not in by_part:
            thread_meta(base, f"partition {p} stalls", base)
        for (a, b) in windows:
            out.append({
                "ph": "X", "name": "stall", "pid": _PID, "tid": base,
                "cat": "stall", "ts": a * _US, "dur": (b - a) * _US,
            })

    # ------------------------------------------------------------------
    # flow events: source sensor slice -> sink slice per E2E completion
    # ------------------------------------------------------------------
    flow_id = 0
    for e in chain_completes:
        data = e.data or {}
        sink = slice_of.get(e.jid)
        if sink is None:
            continue
        src_task = data.get("src_task", "")
        t0 = float(data.get("t0", e.t - e.value))
        flow_id += 1
        violated = bool(data.get("violated"))
        out.append({
            "ph": "s", "id": flow_id, "name": e.chain, "cat": "chain",
            "pid": _PID, "tid": sensor_tid.get(src_task, _TID_SENSOR0),
            "ts": t0 * _US, "args": {"violated": violated},
        })
        out.append({
            "ph": "f", "bp": "e", "id": flow_id, "name": e.chain,
            "cat": "chain", "pid": _PID, "tid": sink["tid"],
            "ts": sink["ts"] + sink["dur"],
            "args": {"violated": violated, "latency_s": e.value},
        })

    other = {str(k): str(v) for k, v in sorted(recorder.meta.items())}
    other["end_s"] = str(end_s)
    return {
        "traceEvents": meta_rows + out,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def export_chrome_trace(
    recorder: TraceRecorder, path: Optional[str] = None, validate: bool = True
) -> dict:
    """Export ``recorder`` to the Trace Event Format; optionally write
    the JSON to ``path`` (loadable in Perfetto / ``chrome://tracing``).

    ``validate`` checks the object against the checked-in schema first
    (cheap; a malformed export fails loudly here instead of silently
    rendering empty in the viewer)."""
    obj = chrome_trace(recorder)
    if validate:
        from .schema import validate_trace

        validate_trace(obj)
    if path is not None:
        with open(path, "w") as fh:
            json.dump(obj, fh)
    return obj
