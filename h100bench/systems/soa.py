"""Runner of the SoA seed-fan cells: the paper's scheduler on the port's
main path, ``repro_torch.scenarios.run(spec, seeds=<fan>, backend="soa")``.

Set-up imports the port, loads its kernels from the build cache and
warms the path with whole fans over fixed lanes.  The window then runs
fresh fans back to back, as a user calls them: fan ``k`` of seed ``s``
takes the lanes ``s * fan_seed_stride + k * lanes + (0 .. lanes - 1)``.
Every fan that starts inside the window counts, to its end.

``correct``: a sample of lanes, drawn from the seed over every fan of
the window, is run again once the window has closed by the frozen
event-driven engine (:mod:`h100bench.ref_soa`), each lane on its own
with draws from the per-seed NumPy sampler.  The round loop approximates
that engine in rounds of ``dt``, so the lanes are compared as the SoA
backend's contract states: the sampler's draws and the structural facts
of each lane exactly, the outcomes over the sample as distributions.
"""
from __future__ import annotations

import sys
import time
import warnings
from typing import Dict, List, Optional

import numpy as np

from .. import counts, harness
from ..tracing import DeviceWindow, Spans, TraceData

__all__ = ["run_cell", "calibrate", "lane_summary", "compare", "DRAW_FIELDS"]

DRAW_FIELDS = ("work", "io", "sensor_lat")
#: lane outcomes read as the relative gap of their means over the sample
OUTCOMES = (("violation_rate", "viol_rel_gap"), ("realloc_frac", "realloc_rel_gap"))
READINGS = ("draw_rel_err", "invariants_differing", "lat_ks", "busy_lane_gap",
            *(n for _, n in OUTCOMES))


def _invariants(report) -> tuple:
    """The facts of a lane that both engines share exactly: the job
    universe, mode switches and their spans, the chain universe and the
    reservation footprint (the SoA backend's structural invariants)."""
    return (report.n_jobs, report.n_mode_switches, tuple(sorted(report.chain_count)),
            tuple(sorted((m, round(s.span_s, 9)) for m, s in report.mode_stats.items())),
            report.total_tiles, report.tiles_used, round(report.tiles_reserved_mean, 6),
            report.duration_s)


def lane_summary(report) -> Dict[str, object]:
    """The per-lane answer that is compared: the outcomes, the structural
    facts and every chain latency (chains in name order)."""
    out: Dict[str, object] = {m: float(getattr(report, m)) for m, _ in OUTCOMES}
    out["busy"] = float(report.effective_frac)
    out["invariants"] = _invariants(report)
    out["lat"] = np.concatenate([np.asarray(report.chain_latencies[c], np.float64)
                                 for c in sorted(report.chain_latencies)] or [np.zeros(0)])
    return out


def _ks(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.sort(a), np.sort(b)
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else 1.0
    pool = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, pool, side="right") / len(a)
                               - np.searchsorted(b, pool, side="right") / len(b))))


def compare(got: List[Dict], want: List[Dict], got_draws: Dict[str, np.ndarray],
            want_draws: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Readings of the program's sampled lanes (``got``) against the
    reference's (``want``), lane by lane in the same order: the draws'
    largest relative error, the lanes whose structural facts differ, the
    KS distance of the pooled chain latencies, the largest relative gap
    of one lane's busy share (the tiles' effective share of the drive,
    which the round loop keeps to a fraction of a percent of the
    engine's, while lanes differ by several), and for the violation rate
    and the realloc waste the gap of the sample's means relative to the
    reference's."""
    if len(got) != len(want) or any(
            np.shape(got_draws[f]) != np.shape(want_draws[f]) for f in DRAW_FIELDS):
        return {name: float("inf") for name in READINGS}
    rel = 0.0
    for f in DRAW_FIELDS:
        a, b = np.asarray(got_draws[f], np.float64), np.asarray(want_draws[f], np.float64)
        err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        rel = max(rel, float(np.max(err, initial=0.0)))
    out = {"draw_rel_err": rel,
           "invariants_differing": float(sum(g["invariants"] != w["invariants"]
                                             for g, w in zip(got, want))),
           "lat_ks": _ks(np.concatenate([g["lat"] for g in got]),
                         np.concatenate([w["lat"] for w in want])),
           "busy_lane_gap": max(abs(g["busy"] - w["busy"]) / max(w["busy"], 1e-12)
                                for g, w in zip(got, want))}
    for m, name in OUTCOMES:
        g = float(np.mean([x[m] for x in got]))
        w = float(np.mean([x[m] for x in want]))
        out[name] = abs(g - w) / max(abs(w), 1e-12)
    return out


def _fan_lanes(seed: int, k: int, lanes: int, stride: int, n_check: int):
    """Fan ``k``'s lane seeds, and the rows of it drawn from the seed to
    be checked."""
    seeds = [int(seed) * stride + k * lanes + j for j in range(lanes)]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, k])
    return seeds, np.sort(rng.choice(lanes, min(n_check, lanes), replace=False))


class _Capture:
    """Around the runner's call into the sampler: keeps the draws of the
    current fan's sampled lanes (rows of the host copy the sampler hands
    back)."""

    def __init__(self, runner, spans: Spans):
        self.runner, self.orig = runner, runner.sample_trace_batch
        self.rows: Optional[np.ndarray] = None
        self.draws: Dict[str, list] = {f: [] for f in DRAW_FIELDS}
        self.spans = spans

        def sampled(*a, **kw):
            with spans.span("sampler"):
                bt = self.orig(*a, **kw)
            if self.rows is not None:
                for f in DRAW_FIELDS:
                    v = getattr(bt, f)
                    v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
                    self.draws[f].append(np.array(v[self.rows], np.float64))
            return bt

        runner.sample_trace_batch = sampled

    def undo(self):
        self.runner.sample_trace_batch = self.orig


class _LaunchWindow:
    """Around the fused allocator's two launchers: counts launches, and
    over launches ``[a, b)`` of the window's first fan holds the device
    profiler open and keeps each launch's shapes for the byte count."""

    def __init__(self, K, window: Optional[DeviceWindow], a: int, b: int):
        self.K, self.window, self.a, self.b = K, window, a, b
        self.n = 0
        self.bytes = 0
        self.launches = 0
        self.orig = (K._edf_alloc_ladder_cuda, K._edf_start_keep_cuda)
        me = self

        def tick():
            if me.window is None:
                return False
            if me.n == me.a and me.window.prof is None:
                me.window.start()
            if me.n == me.b and me.window.active:
                me.window.stop()
            return me.window.active

        def alloc(want, entry, part, cand_rows, cap_p, perm, *rest):
            inside = tick()
            out = me.orig[0](want, entry, part, cand_rows, cap_p, perm, *rest)
            if inside:
                R, W = want.shape
                me.bytes += counts.alloc_ladder_bytes(
                    R, W, cand_rows.shape[-1], cap_p.shape[1], part.shape[0],
                    cand_rows.shape[0] if cand_rows.dim() == 3 else 1, cap_p.shape[0])
                me.launches += 1
            me.n += 1
            return out

        def keep(d, part, avail, perm):
            inside = tick()
            out = me.orig[1](d, part, avail, perm)
            if inside:
                R, W = d.shape
                me.bytes += counts.start_keep_bytes(R, W, avail.shape[1], part.shape[0],
                                                    avail.shape[0])
                me.launches += 1
            me.n += 1
            return out

        K._edf_alloc_ladder_cuda, K._edf_start_keep_cuda = alloc, keep

    def undo(self):
        if self.window is not None and self.window.active:
            self.window.stop()
        self.K._edf_alloc_ladder_cuda, self.K._edf_start_keep_cuda = self.orig


def run_cell(config: Dict, traffic: Dict, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> harness.CellResult:
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core.sim import soa
    from repro_torch.core.sim import soa_kernels as K
    from repro_torch.obs import metrics
    from repro_torch.scenarios import get_scenario, run, runner

    dep = config["deployment"]
    lanes = int(dep["lanes_per_fan"])
    scen = get_scenario(traffic["scenario"])
    duration = float(traffic.get("duration_s") or scen.duration_s)
    spec = _spec(config, traffic)
    cuda = torch.device(device).type == "cuda"

    def fan(seeds):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # the runner's retry notice
            return run(spec, seeds=seeds, backend="soa", fallback=False, device=device)

    if seed < 0:
        raise ValueError(f"--seed must not be negative, got {seed}")
    stride = int(traffic["fan_seed_stride"])
    # set-up: the kernels from the build cache, then whole fans of this
    # cell over fixed lanes (the same for every seed) until the runner
    # keeps a job window that spans the drive.  A first fan finds the
    # window by overflowing and running the loop again; a process that
    # runs many fans does that once, so the window's fans do not.
    for b in range(int(traffic["warmup_fans_max"])):
        base = int(traffic["warmup_seed_base"]) + b * lanes
        fan([base + j for j in range(lanes)])
        hint = getattr(runner, "_SOA_LIFE_PAD_HINT", None)   # the runner's pad per cell
        if not hint or max(hint.values()) >= duration:
            break
    if cuda:
        torch.cuda.synchronize()

    spans = Spans(trace)
    window = DeviceWindow(spans) if (trace and cuda) else None
    undo = []
    cap = _Capture(runner, spans)
    undo.append(cap.undo)
    launches = None
    if trace:
        a, b = traffic["profile_launches"]
        launches = _LaunchWindow(K, window, int(a), int(b))
        undo.append(launches.undo)
        undo.append(spans.wrap(runner, "_prepare_run", "schedule compile"))
        undo.append(spans.wrap(soa, "build_problem", "problem build"))
        undo.append(spans.wrap(K, "simulate", "round loop"))
        undo.append(spans.wrap(soa, "_assemble_reports", "reports"))
        metrics.enable()
        metrics.reset()

    n_check = min(int(traffic["check_lanes_per_fan"]), lanes)
    checked_seeds: List[int] = []
    got: List[Dict] = []
    attempted = failed = 0
    fan_s: List[float] = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    k = 0
    try:
        while True:
            now = time.perf_counter()
            if now >= t0 + seconds:
                break
            seeds, rows = _fan_lanes(seed, k, lanes, stride, n_check)
            cap.rows = rows
            attempted += lanes
            with spans.span("fan"):
                reports = fan(seeds)
            if len(reports) != lanes:
                failed += abs(lanes - len(reports))
            got.extend(lane_summary(reports[i]) for i in rows if i < len(reports))
            checked_seeds.extend(seeds[i] for i in rows)
            del reports
            if window is not None and window.active:
                window.stop()                      # a fan shorter than the launch window
            k += 1
            t_end = time.perf_counter()
            fan_s.append(t_end - (t0 + sum(fan_s)))
    finally:
        for u in reversed(undo):
            u()
    measured = t_end - t0
    snap = metrics.snapshot() if trace else None
    if trace:
        metrics.enable(False)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program's state
    # is freed: each sampled lane through the frozen event-driven engine
    ref = _reference(config, traffic, checked_seeds)
    want = [lane_summary(r) for r in ref["reports"]]
    got_draws = {f: np.concatenate(cap.draws[f]) for f in DRAW_FIELDS}
    readings = compare(got, want, got_draws, ref["draws"])
    print(harness.readings_line(readings), file=sys.stderr, flush=True)
    print(f"fan seconds {fan_s}", file=sys.stderr, flush=True)
    checks = harness.fan_checks(config["checks"], readings)

    e2e = {"drive_s_per_s": k * lanes * duration / measured, "setup_s": setup_s}
    dev = (harness.device_info(1, peak) if cuda else
           {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    data, breakdown = None, None
    if trace:
        data = TraceData(counters=snap["counters"], phases=snap["phases"], spans=spans.items)
        data.extras.update(fans=k, alloc_bytes=launches.bytes,
                           alloc_launches=launches.launches)
        if window is not None and window.prof is not None:
            breakdown = window.reduce(data)
            dev["busy_s"] = data.busy_s
            dev["window_s"] = data.window_s
    return harness.CellResult(end_to_end=e2e, attempted=attempted, failed=failed,
                              checks=checks, device=dev, trace=data, breakdown=breakdown)


def calibrate(config: Dict, traffic: Dict, *, seeds, control_seeds, device: str = "cuda"):
    """Readings for setting the limits, one dict per seed and side, each on
    as many lanes as a run checks over its window's fans, drawn from the
    first fan of the seed: ``program``, the program against the
    reference; for each of ``control_seeds``, ``control``, the reference
    in the program's place with its draws in bfloat16, and ``control_dt``,
    the program with its rounds at twice the configuration's ``dt``; for
    the first three of ``seeds``, ``fault_copied``, the program's fan
    with each checked lane's report taken from the lane half a fan away
    (half the lanes left out, copies in their place)."""
    import torch

    from repro_torch.core.sim import soa
    from repro_torch.scenarios import run, runner

    lanes, stride = int(config["deployment"]["lanes_per_fan"]), int(traffic["fan_seed_stride"])
    n_check = 3 * int(traffic["check_lanes_per_fan"])
    spec = _spec(config, traffic)
    dt = float(config["deployment"]["dt_s"])

    def program(fan_seeds, rows, options=None):
        cap.rows, cap.draws = rows, {f: [] for f in DRAW_FIELDS}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            reports = run(spec, seeds=fan_seeds, backend="soa", fallback=False,
                          device=device, options=options)
        return reports, {f: np.concatenate(v) for f, v in cap.draws.items()}

    cap = _Capture(runner, Spans(False))
    try:
        for n, s in enumerate(seeds):
            fan_seeds, rows = _fan_lanes(s, 0, lanes, stride, n_check)
            reports, draws = program(fan_seeds, rows)
            ref = _reference(config, traffic, [fan_seeds[i] for i in rows])
            want = [lane_summary(r) for r in ref["reports"]]
            yield {"side": "program", "seed": s, **compare(
                [lane_summary(reports[i]) for i in rows], want, draws, ref["draws"])}
            if n < 3:
                copied = [lane_summary(reports[(i + lanes // 2) % lanes]) for i in rows]
                yield {"side": "fault_copied", "seed": s,
                       **compare(copied, want, draws, ref["draws"])}
            del reports
        for s in control_seeds:
            fan_seeds, rows = _fan_lanes(s, 0, lanes, stride, n_check)
            checked = [fan_seeds[i] for i in rows]
            ref = _reference(config, traffic, checked)
            want = [lane_summary(r) for r in ref["reports"]]
            ctl = _reference(config, traffic, checked, draws_dtype=torch.bfloat16)
            yield {"side": "control", "seed": s, **compare(
                [lane_summary(r) for r in ctl["reports"]], want, ctl["draws"], ref["draws"])}
            # the job window sized for the drive, so that no fan retries
            coarse = soa.SoaOptions(dt_s=2 * dt, life_pad_s=spec.scenario.duration_s)
            reports, draws = program(fan_seeds, rows, coarse)
            yield {"side": "control_dt", "seed": s, **compare(
                [lane_summary(reports[i]) for i in rows], want, draws, ref["draws"])}
            del reports
    finally:
        cap.undo()


def _spec(config: Dict, traffic: Dict):
    from repro_torch.scenarios import ScenarioSpec, get_scenario

    dep = config["deployment"]
    return ScenarioSpec(scenario=get_scenario(traffic["scenario"]), policy=traffic["policy"],
                        cockpit_replicas=int(dep["cockpit_replicas"]),
                        drop_policy=dep["drop_policy"], duration_s=traffic.get("duration_s"))


def _reference(config: Dict, traffic: Dict, seeds, draws_dtype=None):
    from ..ref_soa.lanes import reference_lanes

    dep = config["deployment"]
    return reference_lanes(traffic["scenario"], traffic["policy"], int(dep["cockpit_replicas"]),
                           seeds, drop_policy=dep["drop_policy"],
                           duration_s=traffic.get("duration_s"), draws_dtype=draws_dtype)
