"""Batched trace generation for the Tile-stream simulator.

Monte-Carlo sweeps simulate thousands of drives; before this module the
engine sampled every job's workload ``W`` (F1) and I/O latency ``I``
(F2) with one scalar ``RandomState`` call per job, so fleet-scale
sweeps were bottlenecked on per-job Python overhead rather than on
simulation logic.  This module splits job construction into three
cacheable layers:

1. **Skeleton** (:func:`build_skeleton`) — the schedule- and
   seed-independent structure of a run: unrolled task instances per
   rate regime, absolute release times, the dependency CSR, chain
   source maps, per-job driving mode and burst scales.  Memoized on
   ``(workflow signature, scenario token, horizon)``, so every policy,
   replan variant and seed of the same drive shares one skeleton.
2. **Trace** (:func:`sample_trace`) — the per-seed random draws, made
   as a handful of vectorized NumPy array ops per ``(task, mode)``
   bucket instead of per-job scalar calls.
3. **Materialization** (engine ``_build_jobs``) — the cheap per-run
   pass that binds a skeleton + trace to a schedule's plans.

Counter-based stream contract
-----------------------------
Draws do **not** come from a sequential RNG.  Every job's uniforms are
computed by a counter-based construction (splitmix64 mixing, the same
key-to-stream idea as ``Philox``/``Threefry``) keyed on::

    (seed, task name, stream, regime index, cycle, instance index)

with ``stream`` in {WORK, IO, SENSOR}, and are pushed through the
distributions' inverse CDFs (lognormal work via the shared vectorized
:func:`~h100bench.ref_soa.core.latency_model.ndtri`, shifted-exponential I/O,
lognormal sensor latency).  Consequences, which tests pin:

* a job's draw is independent of build order, of the policy/schedule,
  and of the simulation horizon — two runs of the same scenario seed
  see bit-identical ``work_flops``/``io_s`` per job, so policy
  comparisons are exactly paired at the job level;
* truncating or extending the horizon never shifts the draws of the
  jobs both runs share;
* the draws are *distribution-equivalent* to the retired scalar
  ``RandomState`` path (same inverse CDFs, uniform inputs): the KS
  tests in ``tests/test_trace.py`` pin each stream's distribution
  against the analytic CDFs directly.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...obs import metrics
from ..latency_model import LatencyModel, ndtri
from ..workload import Workflow, unroll_hyperperiod

__all__ = [
    "STREAM_WORK",
    "STREAM_IO",
    "STREAM_SENSOR",
    "STREAM_DEGRADE",
    "counter_uniforms",
    "chain_sources",
    "TraceSkeleton",
    "Trace",
    "build_skeleton",
    "sample_trace",
    "storm_drops",
    "clear_skeleton_cache",
]

STREAM_WORK = 0
STREAM_IO = 1
STREAM_SENSOR = 2
#: platform-degradation draws (sensor-dropout storms).  A dedicated
#: stream keeps degraded scenarios on the counter contract *without*
#: perturbing any draw of a degradation-free scenario: the work/io/
#: sensor streams are keyed identically whether or not this one is
#: ever sampled, so existing seeds stay bit-reproducible.
STREAM_DEGRADE = 3

_MASK64 = 0xFFFFFFFFFFFFFFFF
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_C_CYCLE = np.uint64(0xD1342543DE82EF95)
_C_IDX = np.uint64(0x2545F4914F6CDD1D)
_U64 = np.uint64


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (bijective 64-bit mix) on ``uint64`` arrays;
    overflow wraps, which is the point (NumPy wraps unsigned array
    arithmetic silently)."""
    x = x ^ (x >> _U64(30))
    x = x * _M1
    x = x ^ (x >> _U64(27))
    x = x * _M2
    return x ^ (x >> _U64(31))


_MIX_M1 = 0xBF58476D1CE4E5B9
_MIX_M2 = 0x94D049BB133111EB


def _mix64_int(x: int) -> int:
    """The same splitmix64 finalizer on Python ints (exact arithmetic,
    no NumPy scalar-overflow warnings; used for the scalar key fold)."""
    x &= _MASK64
    x ^= x >> 30
    x = (x * _MIX_M1) & _MASK64
    x ^= x >> 27
    x = (x * _MIX_M2) & _MASK64
    return x ^ (x >> 31)


_task_key_cache: Dict[str, int] = {}


def _task_key(task: str) -> int:
    """Stable 64-bit key for a task name (blake2b, platform/run
    independent — ``hash()`` is salted per process and unusable)."""
    k = _task_key_cache.get(task)
    if k is None:
        k = int.from_bytes(
            hashlib.blake2b(task.encode(), digest_size=8).digest(), "little"
        )
        _task_key_cache[task] = k
    return k


def _uniforms_from_keys(
    seed: int,
    stream: int,
    task_keys: np.ndarray,
    regime: np.ndarray,
    cycle: np.ndarray,
    idx: np.ndarray,
) -> np.ndarray:
    """Vectorized core of the stream contract: ``task_keys`` is the
    per-element 64-bit task key (so one call covers jobs of *different*
    tasks).  All array inputs are uint64 of equal length."""
    h = _mix64_int(_mix64_int((seed & _MASK64) ^ int(_GOLDEN)) ^ stream)
    v = _mix64(_U64(h) ^ task_keys)
    v = _mix64(v ^ (regime + _GOLDEN))
    v = _mix64(v ^ (cycle * _C_CYCLE + _U64(1)))
    v = _mix64(v ^ (idx * _C_IDX + _U64(2)))
    # 53 mantissa bits, offset by half an ulp: never exactly 0 or 1
    return ((v >> _U64(11)).astype(np.float64) + 0.5) * (2.0 ** -53)


def counter_uniforms(
    seed: int,
    task: str,
    stream: int,
    regime,
    cycle,
    idx,
) -> np.ndarray:
    """Open-interval (0, 1) uniforms under the stream contract.

    ``regime``/``cycle``/``idx`` are broadcast integer arrays (or
    scalars); the result has their broadcast shape.  Each element is a
    pure function of ``(seed, task, stream, regime, cycle, idx)`` —
    the reference entry point for the contract (tests pin it;
    :func:`sample_trace` uses the same mixing via per-job key arrays).
    """
    regime, cycle, idx = np.broadcast_arrays(
        np.asarray(regime, dtype=np.uint64),
        np.asarray(cycle, dtype=np.uint64),
        np.asarray(idx, dtype=np.uint64),
    )
    keys = np.full(regime.shape, _task_key(task), dtype=np.uint64)
    return _uniforms_from_keys(seed, stream, keys, regime, cycle, idx)


# ---------------------------------------------------------------------------
# chain sources (moved from the engine so the skeleton can cache them)
# ---------------------------------------------------------------------------
def chain_sources(wf: Workflow, insts) -> Dict[Tuple[str, int], float]:
    """(chain name, sink instance index) -> source sample time, by
    walking each sink's predecessor chain through the unrolled instance
    graph (same units as the instances' releases)."""
    inst_by_key = {(i.task, i.index): i for i in insts}
    release_of = {(i.task, i.index): i.release_s for i in insts}

    def trace(chain, sink_idx: int) -> Optional[int]:
        node_i = len(chain.nodes) - 1
        cur = inst_by_key.get((chain.nodes[node_i], sink_idx))
        while cur is not None and node_i > 0:
            prev = chain.nodes[node_i - 1]
            nxt = None
            for (pt, pj) in cur.preds:
                if pt == prev:
                    nxt = inst_by_key.get((pt, pj))
                    break
            cur = nxt
            node_i -= 1
        return cur.index if cur is not None else None

    out: Dict[Tuple[str, int], float] = {}
    for chain in wf.chains:
        sink = chain.nodes[-1]
        n_sink = sum(1 for i in insts if i.task == sink)
        for k in range(n_sink):
            src_idx = trace(chain, k)
            if src_idx is None:
                continue
            out[(chain.name, k)] = release_of[(chain.nodes[0], src_idx)]
    return out


# ---------------------------------------------------------------------------
# local (one-segment) structure, shared by all full cycles of a regime
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _LocalStructure:
    """Per-segment unroll digested into offset-relocatable arrays."""

    tasks: List[str]
    is_sensor: List[bool]
    release: np.ndarray                 # absolute within the segment
    cycle_idx: List[int]                # TaskInstance.index per position
    deps_remaining: List[int]
    succs_local: List[Tuple[int, ...]]  # local successor positions
    sinks: List[Tuple[str, int, float]]  # (chain, local sink pos, src t)
    n: int


def _local_structure(wf: Workflow, insts, src_of) -> _LocalStructure:
    pos_of = {(i.task, i.index): p for p, i in enumerate(insts)}
    sensors = {n for n, t in wf.tasks.items() if t.is_sensor}
    succ_lists: List[List[int]] = [[] for _ in insts]
    deps = [0] * len(insts)
    for p, inst in enumerate(insts):
        deps[p] = len(inst.preds)
        for pred in inst.preds:
            succ_lists[pos_of[pred]].append(p)
    sink_of = {c.name: c.nodes[-1] for c in wf.chains}
    sinks: List[Tuple[str, int, float]] = []
    for (cname, k), src_t in src_of.items():
        sp = pos_of.get((sink_of[cname], k))
        if sp is not None:
            sinks.append((cname, sp, src_t))
    return _LocalStructure(
        tasks=[i.task for i in insts],
        is_sensor=[i.task in sensors for i in insts],
        release=np.asarray([i.release_s for i in insts], dtype=np.float64),
        cycle_idx=[i.index for i in insts],
        deps_remaining=deps,
        succs_local=[tuple(s) for s in succ_lists],
        sinks=sinks,
        n=len(insts),
    )


# ---------------------------------------------------------------------------
# skeleton
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceSkeleton:
    """Schedule- and seed-independent structure of one simulated run.

    Job order and numbering are identical to the engine's historical
    build order (regime-major, cycle-major, unroll order within a
    cycle), so ``jid == array index`` everywhere.  Instances are
    immutable once built — skeletons are shared across Simulators.
    """

    key: tuple
    n: int
    # per-job structure (Python lists for cheap materialization,
    # parallel NumPy arrays for vectorized sampling)
    tasks: List[str]
    cycle: List[int]
    idx: List[int]
    is_sensor: List[bool]
    release_list: List[float]
    drop_at_release: List[bool]
    deps_remaining: List[int]
    succs: List[Tuple[int, ...]]        # absolute jids
    release: np.ndarray
    regime_arr: np.ndarray              # uint64, for the stream contract
    cycle_arr: np.ndarray
    idx_arr: np.ndarray
    task_keys: np.ndarray               # uint64 blake2b task key per job
    dnn_ix: np.ndarray                  # indices of DNN jobs
    sen_ix: np.ndarray                  # indices of sensor jobs
    burst: np.ndarray                   # work multiplier per job (1.0 default)
    mode: List[Optional[str]]           # driving mode at release
    #: (task, mode) -> job index array; the sampling buckets
    buckets: Dict[Tuple[str, Optional[str]], np.ndarray]
    sink_src: Dict[Tuple[str, int], float]
    regimes: List[Tuple[float, float, Workflow]]
    #: model -> (profile token, sampling-parameter arrays) memo
    #: (weakly keyed; see _params_for)
    params_memo: "weakref.WeakKeyDictionary" = dataclasses.field(
        default_factory=lambda: weakref.WeakKeyDictionary(), repr=False
    )


_SKELETON_CACHE: "OrderedDict[tuple, TraceSkeleton]" = OrderedDict()
_SKELETON_CACHE_MAX = 64


def clear_skeleton_cache() -> None:
    """Drop memoized skeletons (test isolation hook)."""
    _SKELETON_CACHE.clear()


def _scenario_token(scenario) -> object:
    if scenario is None:
        return None
    tok = getattr(scenario, "cache_token", None)
    return tok() if callable(tok) else scenario


def build_skeleton(
    wf: Workflow, scenario, duration_s: float
) -> TraceSkeleton:
    """Build (or fetch) the structural skeleton of one run.

    Mirrors the engine's historical ``_build_jobs`` structure exactly:
    piecewise per-rate-regime unrolling, full cycles relocated from one
    segment unroll, truncated seam cycles unrolled separately, and
    within-cycle dependency wiring.
    """
    key = (wf.structural_signature, _scenario_token(scenario), duration_s)
    cached = _SKELETON_CACHE.get(key)
    if cached is not None:
        _SKELETON_CACHE.move_to_end(key)
        metrics.count("skeleton_cache_hit")
        return cached
    with metrics.phase("skeleton_build"):
        skel = _build_skeleton(wf, scenario, duration_s, key)
    _SKELETON_CACHE[key] = skel
    while len(_SKELETON_CACHE) > _SKELETON_CACHE_MAX:
        _SKELETON_CACHE.popitem(last=False)
    return skel


def _build_skeleton(
    wf: Workflow, scenario, duration_s: float, key: tuple
) -> TraceSkeleton:
    """Uncached skeleton construction (see :func:`build_skeleton`)."""
    if scenario is not None and hasattr(scenario, "rate_regimes"):
        regimes = [
            r for r in scenario.rate_regimes(wf, duration_s)
            if r[0] < duration_s - 1e-12
        ]
    else:
        regimes = [(0.0, duration_s, wf)]

    tasks: List[str] = []
    cycle_l: List[int] = []
    idx_l: List[int] = []
    is_sensor: List[bool] = []
    deps: List[int] = []
    succs: List[Tuple[int, ...]] = []
    regime_codes: List[np.ndarray] = []
    cycle_codes: List[np.ndarray] = []
    releases: List[np.ndarray] = []
    sink_src: Dict[Tuple[str, int], float] = {}

    # per-sensor timer anchors (absolute): a rate seam restarts only
    # the *modulated* sensors' hardware timers; an unmodulated sensor
    # keeps its own cadence across the seam.  ``anchors[s]`` is the
    # absolute time sensor s's current grid is anchored at; the phase
    # passed to the unroll is the anchor normalised into the regime
    # start (snapped to 0 within 1e-9 so on-grid seams — every bundled
    # scenario — reproduce the legacy phase-0 unroll bit-for-bit).
    anchors: Dict[str, float] = {}
    prev_periods: Dict[str, float] = {}
    for ri, (r0, r1, wf_r) in enumerate(regimes):
        thp = wf_r.hyper_period_s
        final = ri == len(regimes) - 1
        span = (duration_s - r0) if final else (r1 - r0)
        phases: Dict[str, float] = {}
        for sname, stask in wf_r.tasks.items():
            if not stask.is_sensor:
                continue
            period = stask.period_s
            if prev_periods.get(sname) != period:
                anchors[sname] = r0    # modulated (or first regime): re-anchor
            ph = (anchors[sname] - r0) % period
            if ph < 1e-9 or period - ph < 1e-9:
                ph = 0.0
            if ph:
                phases[sname] = ph
            prev_periods[sname] = period
        # empty mapping -> scalar 0.0: the exact legacy unroll-cache key
        phase_arg = phases if phases else 0.0
        # the - 1e-9 absorbs float accumulation in segment bounds
        # (0.4 + 0.8 > 1.2), which would otherwise add an empty cycle
        n_cycles = max(1, int(math.ceil(span / thp - 1e-9)))
        insts_full = unroll_hyperperiod(
            wf_r, t0=r0, t1=r0 + thp, phase_s=phase_arg
        )
        local_full = _local_structure(wf_r, insts_full, chain_sources(wf_r, insts_full))
        for cycle in range(n_cycles):
            off = cycle * thp
            base = r0 + off
            t1 = base + thp if final else min(base + thp, r1)
            if t1 - base <= 1e-12:
                continue
            if t1 >= base + thp - 1e-12:   # full cycle: relocate
                local = local_full
                rel = local.release + off
                src_off = off
            else:                           # truncated seam cycle
                # the r0-relative phases stay valid at ``base``: thp is
                # a multiple of every sensor period, so the grid offset
                # is congruent modulo each period
                insts = unroll_hyperperiod(
                    wf_r, t0=base, t1=t1, phase_s=phase_arg
                )
                local = _local_structure(wf_r, insts, chain_sources(wf_r, insts))
                rel = local.release
                src_off = 0.0
            base_jid = len(tasks)
            tasks.extend(local.tasks)
            is_sensor.extend(local.is_sensor)
            cycle_l.extend([cycle] * local.n)
            idx_l.extend(local.cycle_idx)
            deps.extend(local.deps_remaining)
            succs.extend(
                tuple(s + base_jid for s in sl) if sl else ()
                for sl in local.succs_local
            )
            releases.append(rel)
            regime_codes.append(np.full(local.n, ri, dtype=np.uint64))
            cycle_codes.append(np.full(local.n, cycle, dtype=np.uint64))
            for cname, sp, src_t in local.sinks:
                sink_src[(cname, base_jid + sp)] = src_t + src_off

    n = len(tasks)
    release = (
        np.concatenate(releases) if releases else np.zeros(0, dtype=np.float64)
    )
    regime_arr = (
        np.concatenate(regime_codes) if regime_codes else np.zeros(0, np.uint64)
    )
    cycle_arr = (
        np.concatenate(cycle_codes) if cycle_codes else np.zeros(0, np.uint64)
    )
    idx_arr = np.asarray(idx_l, dtype=np.uint64)

    # driving mode at release (vectorized mode_at)
    mode: List[Optional[str]]
    if scenario is not None:
        bounds = scenario.boundaries()
        starts = np.asarray([t for t, _m in bounds], dtype=np.float64)
        names = [m for _t, m in bounds]
        seg = np.searchsorted(starts, release, side="right") - 1
        seg = np.clip(seg, 0, len(names) - 1)
        mode = [names[int(s)] for s in seg]
    else:
        mode = [None] * n

    # burst multipliers (work only; sensor entries stay 1 and unused)
    burst = np.ones(n, dtype=np.float64)
    by_task: Dict[str, List[int]] = {}
    for i, t in enumerate(tasks):
        by_task.setdefault(t, []).append(i)
    by_task_arr = {t: np.asarray(ix, dtype=np.intp) for t, ix in by_task.items()}
    if scenario is not None and getattr(scenario, "bursts", ()):
        for b in scenario.bursts:
            for t, ix in by_task_arr.items():
                if is_sensor[ix[0]]:
                    continue
                if b.tasks and t.split("#")[0] not in b.tasks:
                    continue
                r = release[ix]
                m = (r >= b.start_s) & (r < b.start_s + b.duration_s)
                if m.any():
                    burst[ix[m]] *= b.work_scale

    # thermal throttling stretches DNN durations by a deterministic
    # release-time factor, exactly like a burst work multiplier (the
    # draw itself stays on the work stream; docs/degradation.md)
    throttles = getattr(scenario, "throttles", None)
    for th in (throttles() if callable(throttles) else ()):
        for t, ix in by_task_arr.items():
            if is_sensor[ix[0]]:
                continue
            r = release[ix]
            t0, t1 = th.start_s, th.start_s + th.duration_s
            m = (r >= t0) & (r < t1)
            if not m.any():
                continue
            if th.ramp_s > 0.0:
                rise = np.minimum(1.0, (r[m] - t0) / th.ramp_s)
                fall = np.minimum(1.0, (t1 - r[m]) / th.ramp_s)
                f = 1.0 + (th.scale - 1.0) * np.minimum(rise, fall)
            else:
                f = th.scale
            burst[ix[m]] *= f

    # sensor dropout windows
    drop = [False] * n
    if scenario is not None and getattr(scenario, "dropouts", ()):
        for t, ix in by_task_arr.items():
            if not is_sensor[ix[0]]:
                continue
            for i in ix:
                if scenario.dropped(t, float(release[i])):
                    drop[int(i)] = True

    # sampling buckets + per-job stream keys
    buckets: Dict[Tuple[str, Optional[str]], List[int]] = {}
    for i, t in enumerate(tasks):
        buckets.setdefault((t, mode[i]), []).append(i)
    task_keys = np.empty(n, dtype=np.uint64)
    for t, ix in by_task_arr.items():
        task_keys[ix] = _task_key(t)
    sensor_mask = np.asarray(is_sensor, dtype=bool)
    dnn_ix = np.flatnonzero(~sensor_mask)
    sen_ix = np.flatnonzero(sensor_mask)

    skel = TraceSkeleton(
        key=key,
        n=n,
        tasks=tasks,
        cycle=cycle_l,
        idx=idx_l,
        is_sensor=is_sensor,
        release_list=release.tolist(),
        drop_at_release=drop,
        deps_remaining=deps,
        succs=succs,
        release=release,
        regime_arr=regime_arr,
        cycle_arr=cycle_arr,
        idx_arr=idx_arr,
        task_keys=task_keys,
        dnn_ix=dnn_ix,
        sen_ix=sen_ix,
        burst=burst,
        mode=mode,
        buckets={
            k: np.asarray(ix, dtype=np.intp) for k, ix in buckets.items()
        },
        sink_src=sink_src,
        regimes=regimes,
    )
    return skel


# ---------------------------------------------------------------------------
# trace sampling
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Trace:
    """Per-seed sampled randomness, aligned to a skeleton's job order.

    A trace is valid for any Simulator whose (workflow, scenario,
    horizon) matches ``skeleton_key`` *and* whose latency model equals
    the one it was sampled from — the engine verifies the former; the
    caller owns the latter (the scenario runner shares traces only
    across policies of one spec group, which share the model).
    """

    skeleton_key: tuple
    seed: int
    work: np.ndarray        # FLOPs per job (0 for sensors)
    io: np.ndarray          # seconds per job (0 for sensors)
    sensor_lat: np.ndarray  # seconds per job (0 for DNN jobs)
    #: per-job sensor-dropout-storm losses (bool per job, sensors only;
    #: drawn on STREAM_DEGRADE).  None for scenarios without storms —
    #: the common case pays nothing.
    storm_drop: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.work)


def _mode_profiles(model: LatencyModel, scenario):
    if scenario is None:
        return None
    return scenario.profiles_for(model)


@dataclasses.dataclass
class _SampleParams:
    """Per-job distribution parameters flattened to arrays (one entry
    per job; sensor jobs carry the sensor-latency lognormal, DNN jobs
    the work lognormal + I/O shifted exponential)."""

    mean: np.ndarray
    mu: np.ndarray
    sigma: np.ndarray
    io_base: np.ndarray
    io_rate: np.ndarray


def _profile_token(scenario):
    tok = getattr(scenario, "profile_token", None)
    return tok() if callable(tok) else None


def _params_for(skel: TraceSkeleton, model: LatencyModel, scenario) -> _SampleParams:
    """Flatten the (task, mode) profile table into per-job parameter
    arrays, memoized per latency model on the (cached) skeleton — the
    profile lookup work is then paid once per (skeleton, model), not
    once per seed.  The memo also carries the scenario's profile token
    (the mode objects, value-compared): a mode re-registered with
    different profile transforms must not reuse stale parameters even
    though the structural skeleton is rightly still valid."""
    token = _profile_token(scenario)
    hit = skel.params_memo.get(model)
    if hit is not None and hit[0] == token:
        return hit[1]
    n = skel.n
    par = _SampleParams(
        mean=np.zeros(n), mu=np.zeros(n), sigma=np.zeros(n),
        io_base=np.zeros(n), io_rate=np.zeros(n),
    )
    profs = _mode_profiles(model, scenario)
    for (task, mode), ix in skel.buckets.items():
        prof = model.profiles[task] if profs is None else profs[mode][task]
        dist = prof.sensor_latency if prof.is_sensor else prof.work
        par.mean[ix] = dist.mean
        par.mu[ix] = dist.mu
        par.sigma[ix] = dist.sigma
        if not prof.is_sensor:
            par.io_base[ix] = prof.io.base
            par.io_rate[ix] = prof.io.rate
    skel.params_memo[model] = (token, par)
    return par


def _lognormal_from_uniforms(
    u: np.ndarray, mean: np.ndarray, mu: np.ndarray, sigma: np.ndarray
) -> np.ndarray:
    """Inverse-CDF lognormal, matching ``LogNormal.quantiles`` exactly:
    zero for zero-mean, the mean for zero sigma, else exp(mu+sigma z)."""
    with np.errstate(invalid="ignore"):
        vals = np.exp(mu + sigma * ndtri(u))
    return np.where(mean <= 0.0, 0.0, np.where(sigma <= 0.0, mean, vals))


def sample_trace(
    skel: TraceSkeleton,
    model: LatencyModel,
    scenario,
    seed: int,
) -> Trace:
    """Draw every job's randomness as a handful of whole-trace array
    ops: one uniform + inverse-CDF pass per stream (work, I/O, sensor
    latency), with per-job distribution parameters gathered once per
    (skeleton, model).  Uniform inputs follow the counter-based stream
    contract (module docstring) — bit-identical to per-bucket
    :func:`counter_uniforms` calls.
    """
    with metrics.phase("trace_sample"):
        return _sample_trace(skel, model, scenario, seed)


def _sample_trace(
    skel: TraceSkeleton,
    model: LatencyModel,
    scenario,
    seed: int,
) -> Trace:
    n = skel.n
    work = np.zeros(n, dtype=np.float64)
    io = np.zeros(n, dtype=np.float64)
    sensor_lat = np.zeros(n, dtype=np.float64)
    par = _params_for(skel, model, scenario)

    d = skel.dnn_ix
    if d.size:
        keys, reg = skel.task_keys[d], skel.regime_arr[d]
        cyc, idx = skel.cycle_arr[d], skel.idx_arr[d]
        uw = _uniforms_from_keys(seed, STREAM_WORK, keys, reg, cyc, idx)
        ui = _uniforms_from_keys(seed, STREAM_IO, keys, reg, cyc, idx)
        work[d] = _lognormal_from_uniforms(
            uw, par.mean[d], par.mu[d], par.sigma[d]
        ) * skel.burst[d]
        rate = par.io_rate[d]
        safe = np.where(rate > 0.0, rate, 1.0)
        queue = -np.log(np.maximum(1.0 - ui, 1e-300)) / safe
        io[d] = par.io_base[d] + np.where(rate > 0.0, queue, 0.0)

    s = skel.sen_ix
    if s.size:
        keys, reg = skel.task_keys[s], skel.regime_arr[s]
        cyc, idx = skel.cycle_arr[s], skel.idx_arr[s]
        u = _uniforms_from_keys(seed, STREAM_SENSOR, keys, reg, cyc, idx)
        # legacy range: uniform(0.001, 0.999) into the quantile
        sensor_lat[s] = _lognormal_from_uniforms(
            0.001 + 0.998 * u, par.mean[s], par.mu[s], par.sigma[s]
        )
    return Trace(
        skeleton_key=skel.key, seed=seed,
        work=work, io=io, sensor_lat=sensor_lat,
        storm_drop=storm_drops(skel, scenario, seed),
    )


def storm_drops(
    skel: TraceSkeleton, scenario, seed: int
) -> Optional[np.ndarray]:
    """Per-job sensor-dropout-storm verdicts for one seed.

    One uniform per sensor release inside any storm window, drawn on
    ``STREAM_DEGRADE`` — scenarios without storms draw nothing (and
    return ``None``), so their work/io/sensor streams are untouched and
    existing seeds stay bit-reproducible.  Overlapping storms compose
    as independent loss processes (complement product), evaluated at
    the frame's release time.
    """
    storms = getattr(scenario, "storms", None)
    storms = storms() if callable(storms) else ()
    s = skel.sen_ix
    if not storms or not s.size:
        return None
    rel = skel.release[s]
    base = [skel.tasks[int(j)].split("#")[0] for j in s]
    keep = np.ones(s.size, dtype=np.float64)
    for st in storms:
        m = (rel >= st.start_s) & (rel < st.start_s + st.duration_s)
        if st.sensors:
            m &= np.asarray([b in st.sensors for b in base], dtype=bool)
        keep[m] *= 1.0 - st.drop_frac
    frac = 1.0 - keep
    cand = frac > 0.0
    if not cand.any():
        return None
    ix = s[cand]
    u = _uniforms_from_keys(
        seed, STREAM_DEGRADE, skel.task_keys[ix], skel.regime_arr[ix],
        skel.cycle_arr[ix], skel.idx_arr[ix],
    )
    out = np.zeros(skel.n, dtype=bool)
    out[ix] = u < frac[cand]
    return out
