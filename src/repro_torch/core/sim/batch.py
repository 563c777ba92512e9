"""Batched lockstep Monte-Carlo engine, batched trace materialization
and report digests.

``run_batch`` advances B :class:`~repro_torch.core.sim.engine.Simulator`
lanes of the *same scenario skeleton* in lockstep windows (one window
per scenario segment boundary).  Three layers make the batch axis pay:

1. **Batched trace materialization** — :func:`sample_trace_batch`
   evaluates the counter-based stream contract once for all seeds as
   ``(B, n)`` array ops: the seed only enters the scalar key fold, so
   a ``(B, 1)`` seed-hash column broadcast against the ``(n,)`` per-job
   key arrays yields every lane's uniforms in one pass.  Each host
   (NumPy) row is bit-identical to
   :func:`~repro_torch.core.sim.trace.sample_trace` for that seed.
2. **Batch-shared precomputations** — the per-chain expected-sink
   statics of the report (trace-independent) are computed once and
   injected into every lane (:class:`LaneSimulator`), and the policies'
   per-job DoP duration ladders are prefilled from vectorized
   ``(n_jobs, n_cands)`` kernels instead of lazy per-candidate scalar
   evaluation (:func:`_prefill_ladders`).
3. **Fused per-lane cores** — for the supported configurations
   (``cyc``/``cyc_s``/``tp_driven``/``ads_tile`` with no recorder and at
   most a reactive :class:`~repro_torch.core.runtime.replan.OnlineReplanner`)
   the event dispatch and the policy's scheduling-point body run as one
   fused loop (:class:`_FastLane`) over bound locals — the same
   arithmetic in the same order as the scalar engine + policy pair,
   without the per-event method-call tax.  Everything mid-frequency
   (``start_job``/``resize``/``terminate``/``hotswap``/finish
   accounting) still runs through the engine's own verbs, so the two
   code paths can only diverge in the fused hot loop, which the tests
   hold bit for bit against the scalar engine.

Lane divergence is handled *per lane*: a configuration the fused core
does not support (a recorder attached, a predictive replanner, an
unknown policy subclass) falls back to the scalar engine's own
``_prime``/``_step``/``_finalize`` driver (:class:`_ScalarLane`) but
stays inside the lockstep window loop, so mixed batches are legal and
each lane's report is bit-identical either way.

The lockstep engine is host NumPy and takes the NumPy trace path.
``sample_trace_batch(..., device=...)`` runs the same pass as torch
ops on that device (the SoA backend's path).  The splitmix64 integer
pipeline is carried in ``int64``: multiplies wrap, a logical right
shift is an arithmetic shift followed by a mask, and constants above
2**63 are written as their two's-complement values.  So its uniforms
are bit-identical to the NumPy path; the float64 quantile transforms
after them may differ in the last ulp, which is why the lockstep
engine never uses it.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._device import resolve_device
from ...obs import metrics
from ..latency_model import (
    _NDTRI_PLOW,
    LatencyModel,
    _ndtri_central,
    _ndtri_tail,
)
from .engine import JobState, Simulator, SimReport
from .trace import (
    _C_CYCLE,
    _C_IDX,
    _GOLDEN,
    _M1,
    _M2,
    _MASK64,
    _U64,
    STREAM_IO,
    STREAM_SENSOR,
    STREAM_WORK,
    Trace,
    TraceSkeleton,
    _lognormal_from_uniforms,
    _mix64,
    _mix64_int,
    _params_for,
    storm_drops,
)

__all__ = [
    "BatchTrace",
    "sample_trace_batch",
    "LaneSimulator",
    "run_batch",
    "fast_lane_supported",
    "report_digest",
    "reports_identical",
]


# ---------------------------------------------------------------------------
# batched trace materialization
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BatchTrace:
    """Per-seed randomness for B lanes, aligned to one skeleton.

    Row ``k`` of the host path is bit-identical to ``sample_trace(skel,
    model, scen, seeds[k])`` — :meth:`lane` returns it as an ordinary
    :class:`~repro_torch.core.sim.trace.Trace` (row views, no copy).
    """

    skeleton_key: tuple
    seeds: Tuple[int, ...]
    work: np.ndarray        # (B, n) FLOPs per job (0 for sensors)
    io: np.ndarray          # (B, n) seconds per job
    sensor_lat: np.ndarray  # (B, n) seconds per job (0 for DNN jobs)
    #: per-lane sensor-dropout-storm verdicts (see Trace.storm_drop);
    #: None when the scenario has no storms
    storm_drop: Optional[Tuple[Optional[np.ndarray], ...]] = None

    @property
    def batch(self) -> int:
        return len(self.seeds)

    def lane(self, k: int) -> Trace:
        return Trace(
            skeleton_key=self.skeleton_key,
            seed=self.seeds[k],
            work=self.work[k],
            io=self.io[k],
            sensor_lat=self.sensor_lat[k],
            storm_drop=(
                None if self.storm_drop is None else self.storm_drop[k]
            ),
        )


def _seed_hashes(seeds: Sequence[int], stream: int) -> list:
    """The scalar seed fold of the stream contract (exact Python ints)."""
    return [
        _mix64_int(_mix64_int((s & _MASK64) ^ int(_GOLDEN)) ^ stream)
        for s in seeds
    ]


def _uniforms_batch(
    seeds: Sequence[int],
    stream: int,
    task_keys: np.ndarray,
    regime: np.ndarray,
    cycle: np.ndarray,
    idx: np.ndarray,
) -> np.ndarray:
    """(B, n) uniforms under the stream contract: the scalar seed fold
    becomes a (B, 1) column, everything after it broadcasts elementwise
    — so row ``k`` equals the scalar ``_uniforms_from_keys(seeds[k],
    ...)`` bit-for-bit."""
    h = np.asarray(_seed_hashes(seeds, stream), dtype=np.uint64).reshape(-1, 1)
    v = _mix64(h ^ task_keys)
    v = _mix64(v ^ (regime + _GOLDEN))
    v = _mix64(v ^ (cycle * _C_CYCLE + _U64(1)))
    v = _mix64(v ^ (idx * _C_IDX + _U64(2)))
    return ((v >> _U64(11)).astype(np.float64) + 0.5) * (2.0 ** -53)


# ---------------------------------------------------------------------------
# torch sampling path — used by the SoA backend
# ---------------------------------------------------------------------------
def _i64(u: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    u = int(u) & _MASK64
    return u - (1 << 64) if u >= (1 << 63) else u


_M1_I64 = _i64(_M1)
_M2_I64 = _i64(_M2)
_GOLDEN_I64 = _i64(_GOLDEN)
_C_CYCLE_I64 = _i64(_C_CYCLE)
_C_IDX_I64 = _i64(_C_IDX)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch has no uint64 ``>>``):
    the arithmetic shift smears the sign bit into the top ``k`` bits,
    the mask clears them."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64_t(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 tensors (wrapping multiplies)."""
    x = x ^ _shr(x, 30)
    x = x * _M1_I64
    x = x ^ _shr(x, 27)
    x = x * _M2_I64
    return x ^ _shr(x, 31)


def _u64_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A uint64 array's bits as an int64 tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def _ndtri_t(q: torch.Tensor) -> torch.Tensor:
    """Acklam inverse-normal on float64 tensors, mirroring
    :func:`repro_torch.core.latency_model.ndtri` branch for branch —
    *including* the +-inf boundary clamps: the stream contract's
    uniforms are ``(m + 0.5) * 2**-53`` whose supremum ``1 - 2**-54``
    rounds to exactly 1.0 in binary64, so ``q >= 1.0`` is a reachable
    input and must map to ``+inf`` like the NumPy path."""
    qc = q.clamp(1e-300, 1.0 - 1e-16)
    lo_t = _ndtri_tail(torch.sqrt(-2.0 * torch.log(qc)))
    hi_t = -_ndtri_tail(torch.sqrt(-2.0 * torch.log(1.0 - qc)))
    out = torch.where(
        q < _NDTRI_PLOW,
        lo_t,
        torch.where(q > 1.0 - _NDTRI_PLOW, hi_t, _ndtri_central(qc)),
    )
    inf = torch.full_like(q, math.inf)
    return torch.where(q <= 0.0, -inf, torch.where(q >= 1.0, inf, out))


def _uniforms_batch_t(seeds, stream, keys, reg, cyc, idx) -> torch.Tensor:
    """Torch mirror of :func:`_uniforms_batch`: the seed fold stays on
    the host (exact Python ints), the broadcast mix runs as int64 ops
    on the tensors' device.  Bit-identical to the NumPy path."""
    h = torch.tensor(
        [_i64(x) for x in _seed_hashes(seeds, stream)],
        dtype=torch.int64, device=keys.device,
    ).reshape(-1, 1)
    v = _mix64_t(h ^ keys)
    v = _mix64_t(v ^ (reg + _GOLDEN_I64))
    v = _mix64_t(v ^ (cyc * _C_CYCLE_I64 + 1))
    v = _mix64_t(v ^ (idx * _C_IDX_I64 + 2))
    return (_shr(v, 11).to(torch.float64) + 0.5) * (2.0 ** -53)


def _lognormal_t(u, mean, mu, sigma) -> torch.Tensor:
    vals = torch.exp(mu + sigma * _ndtri_t(u))
    return torch.where(
        mean <= 0.0, torch.zeros_like(vals), torch.where(sigma <= 0.0, mean, vals)
    )


def _sample_trace_batch_t(skel, par, seeds, device):
    """All lanes' draws in one float64 pass on ``device``.  Returns
    host ndarrays — BatchTrace consumers are NumPy."""
    B, n = len(seeds), skel.n
    work = np.zeros((B, n), dtype=np.float64)
    io = np.zeros((B, n), dtype=np.float64)
    sensor_lat = np.zeros((B, n), dtype=np.float64)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    def streams(ix):
        return tuple(
            _u64_tensor(a[ix], device)
            for a in (skel.task_keys, skel.regime_arr, skel.cycle_arr,
                      skel.idx_arr)
        )

    d = skel.dnn_ix
    if d.size and B:
        keys, reg, cyc, idx = streams(d)
        uw = _uniforms_batch_t(seeds, STREAM_WORK, keys, reg, cyc, idx)
        ui = _uniforms_batch_t(seeds, STREAM_IO, keys, reg, cyc, idx)
        w = _lognormal_t(uw, f64(par.mean[d]), f64(par.mu[d]), f64(par.sigma[d]))
        work[:, d] = (w * f64(skel.burst[d])).cpu().numpy()
        rate = f64(par.io_rate[d])
        safe = torch.where(rate > 0.0, rate, torch.ones_like(rate))
        queue = -torch.log(torch.clamp(1.0 - ui, min=1e-300)) / safe
        io[:, d] = (
            f64(par.io_base[d]) + torch.where(rate > 0.0, queue, torch.zeros_like(queue))
        ).cpu().numpy()

    s = skel.sen_ix
    if s.size and B:
        keys, reg, cyc, idx = streams(s)
        u = _uniforms_batch_t(seeds, STREAM_SENSOR, keys, reg, cyc, idx)
        lat = _lognormal_t(
            0.001 + 0.998 * u, f64(par.mean[s]), f64(par.mu[s]), f64(par.sigma[s])
        )
        sensor_lat[:, s] = lat.cpu().numpy()
    return work, io, sensor_lat


def sample_trace_batch(
    skel: TraceSkeleton,
    model: LatencyModel,
    scenario,
    seeds: Sequence[int],
    device=None,
) -> BatchTrace:
    """Materialize B seeds' traces in one vectorized pass (the batched
    mirror of :func:`~repro_torch.core.sim.trace.sample_trace`).

    ``device=None`` keeps the NumPy host path (bit-identical rows).  A
    torch device (``"cuda"``, ``"cpu"``) runs the pass as torch ops on
    it: the same stream contract and the same integer hash bit for
    bit, but the float quantile transforms may differ from the NumPy
    path in the last ulp — fine under the SoA backend's distributional
    contract.  ``"cuda"`` without a CUDA device raises.
    """
    with metrics.phase("trace_sample"):
        seeds = tuple(int(s) for s in seeds)
        B, n = len(seeds), skel.n
        par = _params_for(skel, model, scenario)
        # storm verdicts are host-side per-lane draws (the scalar
        # helper, so each lane is bit-identical to sample_trace)
        drops = tuple(storm_drops(skel, scenario, s) for s in seeds)
        storm = None if all(d is None for d in drops) else drops
        if device is not None:
            work, io, sensor_lat = _sample_trace_batch_t(
                skel, par, seeds, resolve_device(device)
            )
            return BatchTrace(
                skeleton_key=skel.key,
                seeds=seeds,
                work=work,
                io=io,
                sensor_lat=sensor_lat,
                storm_drop=storm,
            )
        work = np.zeros((B, n), dtype=np.float64)
        io = np.zeros((B, n), dtype=np.float64)
        sensor_lat = np.zeros((B, n), dtype=np.float64)

        d = skel.dnn_ix
        if d.size and B:
            keys, reg = skel.task_keys[d], skel.regime_arr[d]
            cyc, idx = skel.cycle_arr[d], skel.idx_arr[d]
            uw = _uniforms_batch(seeds, STREAM_WORK, keys, reg, cyc, idx)
            ui = _uniforms_batch(seeds, STREAM_IO, keys, reg, cyc, idx)
            work[:, d] = (
                _lognormal_from_uniforms(uw, par.mean[d], par.mu[d], par.sigma[d])
                * skel.burst[d]
            )
            rate = par.io_rate[d]
            safe = np.where(rate > 0.0, rate, 1.0)
            queue = -np.log(np.maximum(1.0 - ui, 1e-300)) / safe
            io[:, d] = par.io_base[d] + np.where(rate > 0.0, queue, 0.0)

        s = skel.sen_ix
        if s.size and B:
            keys, reg = skel.task_keys[s], skel.regime_arr[s]
            cyc, idx = skel.cycle_arr[s], skel.idx_arr[s]
            u = _uniforms_batch(seeds, STREAM_SENSOR, keys, reg, cyc, idx)
            sensor_lat[:, s] = _lognormal_from_uniforms(
                0.001 + 0.998 * u, par.mean[s], par.mu[s], par.sigma[s]
            )
        return BatchTrace(
            skeleton_key=skel.key,
            seeds=seeds,
            work=work,
            io=io,
            sensor_lat=sensor_lat,
            storm_drop=storm,
        )


# ---------------------------------------------------------------------------
# lane simulator: scalar engine + batch-shared statics
# ---------------------------------------------------------------------------
class LaneSimulator(Simulator):
    """One lane of a batch: identical semantics to
    :class:`~repro_torch.core.sim.engine.Simulator`, with the report's
    per-chain expected-sink statics injected once per batch (they are a
    pure function of the shared skeleton + scenario, see
    ``Simulator._chain_expectations``)."""

    _shared_expectations: Optional[Dict[str, tuple]] = None

    def _chain_expectations(self) -> Dict[str, tuple]:
        shared = self._shared_expectations
        if shared is not None:
            return shared
        return super()._chain_expectations()


# ---------------------------------------------------------------------------
# fast-lane eligibility
# ---------------------------------------------------------------------------
def fast_lane_supported(sim: Simulator) -> bool:
    """Whether ``sim`` can run on the fused fast core.

    Exact-type checks on purpose: an unknown policy subclass (or a
    predictive replanner, or an attached recorder, whose hook sites
    live in the engine paths the fused loop inlines) silently falls
    back to the scalar per-lane driver instead of risking divergence.
    """
    from ..baselines.cyclic import CyclicPolicy, ElasticCyclicPolicy
    from ..baselines.tpdriven import TpDrivenPolicy
    from ..runtime.replan import OnlineReplanner
    from ..runtime.scheduler import AdsTilePolicy

    if sim.cfg.recorder is not None:
        return False
    # injected platform degradations route through engine seams
    # (capacity loss, bandwidth scaling, degrade accounting) that the
    # fused loop does not inline — scalar-lane fallback, bit-identical
    # by construction
    if getattr(sim.cfg.scenario, "has_degradations", False):
        return False
    pol = sim.policy
    rep = pol.replanner
    if rep is not None and type(rep) is not OnlineReplanner:
        return False
    return type(pol) in (
        CyclicPolicy,
        ElasticCyclicPolicy,
        TpDrivenPolicy,
        AdsTilePolicy,
    )


# sort keys shared by the fused policy kernels (match the scalar
# policies' lambdas exactly)
def _ddl_key(j):
    return (j.sub_ddl, j.jid)


def _ert_key(j):
    return (j.ert, j.sub_ddl)


_POL_CYC = 0
_POL_TP = 1
_POL_ADS = 2


class _ScalarLane:
    """Fallback lane: the scalar engine driven window-by-window through
    its own ``_step``; bit-identical to ``Simulator._run`` by
    construction."""

    __slots__ = ("sim",)
    fused = False

    def __init__(self, sim: Simulator):
        self.sim = sim

    def advance_until(self, t_hi: float) -> None:
        sim = self.sim
        heap = sim._heap
        step = sim._step
        while heap and heap[0][0] <= t_hi:
            step()


class _FastLane:
    """Fused event loop: scalar-engine dispatch + the policy's
    scheduling-point body inlined over bound locals.

    Every state mutation either replicates the engine's expression
    verbatim (progress advance, event pushes) or calls the engine's own
    verb (``start_job``/``resize``/``terminate``/``_finish_job``/
    ``_set_rate``/``hotswap``), so the lane's state trajectory is the
    scalar engine's, event for event.  Nested scheduling points raised
    from inside engine verbs (e.g. the ``"drop"`` point fired by
    ``terminate``) intentionally run the *real* policy object — they
    are rare, and reusing them keeps this loop small enough to audit
    against the scalar sources line by line.

    In addition to inlining, the ads_tile kernel carries a
    per-partition **quiet-until cache** (``_quiet``) for its dominant
    case: no admissible ready job and no at-risk running job.  There
    the whole Algorithm-2 pass is a no-op, and it stays one until the
    earliest ChkTrigger flip: for a job running steadily at DoP ``c``,
    ``now + (1-progress)*d(c)`` is *constant* (progress advances at
    exactly ``1/d(c)``), so the at-risk inequality cannot trip before
    ``target - remaining`` computed at cache time — a conservative
    horizon, stored minus a 1e-6 s guard band (orders of magnitude
    above float64 rounding at these scales).  Until that horizon,
    repeated chunk/ert scheduling points are skipped outright; the
    scalar engine re-derives the same no-op.  Anything that breaks the
    frozen-inputs argument — a finish, a terminate (whose nested
    ``"drop"`` point runs the real policy), a stall resume, a
    schedule hot-swap — resets the cache, and a ready/ert arrival is
    caught structurally because the admitted-ready check runs *before*
    the cache is consulted.  No horizon is cached for any pass that
    inspects ready jobs or candidate ladders of differing DoPs
    (FitQuota picks are not monotone once progress advances), so
    skipping never changes a decision.
    """

    __slots__ = (
        "sim",
        "pol",
        "pol_kind",
        "tf",
        "elastic",
        "drop_on_subddl",
        "drop_hard",
        "ads_admission",
        "_quiet",
        "_chunk_pts",
        "_fixed_dop",
        "_n_chunks",
        "_sink_chains",
    )
    fused = True

    def __init__(self, sim: Simulator):
        from ..baselines.cyclic import CyclicPolicy
        from ..baselines.tpdriven import TpDrivenPolicy

        self.sim = sim
        self.pol = pol = sim.policy
        if isinstance(pol, TpDrivenPolicy):
            self.pol_kind = _POL_TP
        elif isinstance(pol, CyclicPolicy):
            self.pol_kind = _POL_CYC
        else:
            self.pol_kind = _POL_ADS
        self.tf = sim.hw.tile_flops
        self.elastic = bool(getattr(pol, "elastic", False))
        self.drop_on_subddl = bool(getattr(pol, "drop_on_subddl", False))
        self.drop_hard = sim.cfg.drop_policy == "hard"
        self.ads_admission = bool(getattr(pol, "admission", True))
        #: per-partition no-op horizon (None = must re-evaluate)
        self._quiet: List[Optional[float]] = [None] * len(sim.parts)
        self._chunk_pts = sim._chunk_points
        self._fixed_dop = sim._fixed_dop
        self._n_chunks = sim.cfg.n_chunks
        #: task -> chains ending there (workload keeps this dict; the
        #: per-finish method call is the only thing skipped)
        self._sink_chains = sim.wf._chains_ending

    # -- event push mirrors (engine _push / arm_timer) -------------------
    def _arm(self, partition: int, t: float, jid: int) -> None:
        sim = self.sim
        if t > sim._end_t:
            return
        sim._seq = seq = sim._seq + 1
        heapq.heappush(sim._heap, (t, seq, "timer", (partition, jid)))

    # -- fused engine verbs ----------------------------------------------
    # ``start_job``/``_set_rate``/``_finish_job`` with the recorder
    # guards dropped (fused lanes are recorder-free by construction, see
    # ``fast_lane_supported``), asserts elided, and ``_touch``/
    # ``_propagate``/``_push`` bodies inlined.  Every arithmetic
    # expression is the engine's, verbatim — only call overhead goes.
    def _touch_part(self, part, now: float) -> None:
        dt = now - part.last_t
        if dt > 0:
            sim = self.sim
            alloc = part.alloc
            mode = sim._mode_now
            if part.stalled:
                part.realloc_ts += alloc * dt
                if mode is not None:
                    sim._mode_realloc[mode] = (
                        sim._mode_realloc.get(mode, 0.0) + alloc * dt
                    )
            else:
                part.busy_ts += alloc * dt
                if mode is not None:
                    sim._mode_busy[mode] = sim._mode_busy.get(mode, 0.0) + alloc * dt
        part.last_t = now

    def _rate(self, job) -> None:
        sim = self.sim
        now = sim.now
        job.gen += 1
        c = job.dop
        memo = job._dur
        if memo is None:
            memo = job._dur = {}
        d = memo.get(c)
        if d is None:
            # running jobs are never sensors and dop >= 1
            d = memo[c] = (
                job.work_flops / (c * self.tf)
                + job.io_s
                + job.sync_s * (c - 1)
            )
        job.rate = rate = 1.0 / (d if d > 1e-9 else 1e-9)
        heap = sim._heap
        end_t = sim._end_t
        t = now + (1.0 - job.progress) / rate
        if t <= end_t:
            sim._seq = seq = sim._seq + 1
            heapq.heappush(heap, (t, seq, "finish", (job.jid, job.gen)))
        if not self._chunk_pts or job.task in self._fixed_dop:
            return
        n = self._n_chunks
        nxt = math.floor(job.progress * n + 1e-9) + 1
        if nxt < n:
            t = now + (nxt / n - job.progress) / rate
            if t <= end_t:
                sim._seq = seq = sim._seq + 1
                heapq.heappush(heap, (t, seq, "chunk", (job.jid, job.gen)))

    def _start(self, job, dop: int) -> None:
        sim = self.sim
        now = sim.now
        part = sim.parts[job.partition]
        self._touch_part(part, now)
        sim._ready_sets[job.partition].pop(job, None)
        job.state = JobState.RUNNING
        job.start_t = now
        job.dop = dop
        job.last_t = now
        part.running[job.jid] = dop
        part.alloc += dop
        if part.stalled:
            job.rate = 0.0  # will start when the stall ends
        else:
            self._rate(job)

    def _finish(self, job) -> None:
        sim = self.sim
        now = sim.now
        jp = job.partition
        if jp >= 0:
            part = sim.parts[jp]
            if job.jid in part.running:
                self._touch_part(part, now)
                part.alloc -= part.running.pop(job.jid)
        job.state = JobState.DONE
        job.progress = 1.0
        job.finish_t = now
        job.rate = 0.0
        job.gen += 1
        # _propagate (job.state is DONE here, so the DROPPED test in the
        # engine's degradation check reduces to job.degraded)
        succs = job.succs
        if succs:
            jobs = sim.jobs
            rsets = sim._ready_sets
            heap = sim._heap
            end_t = sim._end_t
            jdeg = job.degraded
            PENDING = JobState.PENDING
            READY = JobState.READY
            for sid in succs:
                succ = jobs[sid]
                if jdeg:
                    succ.degraded = True
                succ.deps_remaining -= 1
                if succ.deps_remaining == 0 and succ.state is PENDING:
                    succ.state = READY
                    succ.ready_t = now
                    if succ.is_sensor:
                        continue
                    rsets[succ.partition][succ] = None
                    if now <= end_t:
                        sim._seq = seq = sim._seq + 1
                        heapq.heappush(heap, (now, seq, "ready", (succ.jid,)))
                    ert = succ.ert
                    if ert > now and ert <= end_t:
                        sim._seq = seq = sim._seq + 1
                        heapq.heappush(heap, (ert, seq, "ert", (succ.jid,)))
        # chain accounting at sinks
        chains = self._sink_chains[job.task]
        if chains:
            sink_src = sim._sink_src
            cfg = sim.cfg
            collect = cfg.collect_latencies
            scenario = cfg.scenario
            for chain in chains:
                t0 = sink_src.get((chain.name, job.jid))
                if t0 is None:
                    continue
                lat = now - t0
                violated = lat > chain.deadline_s + 1e-12 or job.degraded
                sim.chain_count[chain.name] += 1
                if collect:
                    sim.chain_latencies[chain.name].append(lat)
                if violated:
                    sim.chain_violations[chain.name] += 1
                if scenario is not None:
                    m = scenario.mode_at(t0)
                    rec = sim._sink_by_mode.setdefault((chain.name, m), [0, 0])
                    rec[0] += 1
                    rec[1] += int(violated)
                    if collect:
                        sim._mode_lats.setdefault(m, []).append(lat)

    # -- fused policy scheduling points ----------------------------------
    def _cyc_try_start(self, partition: int) -> None:
        sim = self.sim
        part = sim.parts[partition]
        rs = sim._ready_sets[partition]
        if self.elastic:
            ready = list(rs)
        else:
            lim = sim.now + 1e-12
            ready = [j for j in rs if j.ert <= lim]
        if not ready:
            return
        ready.sort(key=_ert_key)
        elastic = self.elastic
        drop_hard = self.drop_hard
        start = self._start
        for job in ready:
            if job.plan_dop <= part.capacity - part.alloc:
                start(job, job.plan_dop)
                if not elastic:
                    self._arm(partition, job.sub_ddl, job.jid)
                elif drop_hard:
                    self._arm(partition, job.e2e_ddl, job.jid)

    def _tp_reallocate(self, partition: int) -> None:
        sim = self.sim
        part = sim.parts[partition]
        if part.stalled:
            return
        now = sim.now
        tf = self.tf
        jobs = sim.jobs
        cands_of = self.pol._cands
        running = [jobs[jid] for jid in part.running]
        queue = running + list(sim._ready_sets[partition])
        queue.sort(key=_ddl_key)

        # EDF quota pass (tpdriven._reallocate, verbatim arithmetic)
        alloc: Dict[int, int] = {}
        left = part.capacity
        for job in queue:
            cands = cands_of[job.task]
            slack = job.sub_ddl - now
            rem = 1.0 - job.progress
            lad = job._ladder
            if lad is None or lad[0] is not cands:
                lad = job._ladder = (
                    cands,
                    tuple(job.duration(c, tf) for c in cands),
                )
            durs = lad[1]
            pick = 0
            i = 0
            for c in cands:
                if c > left:
                    break
                pick = c
                if rem * durs[i] <= slack:
                    break
                i += 1
            alloc[job.jid] = pick
            left -= pick

        # work-conserving bump pass
        bumped = True
        while left > 0 and bumped:
            bumped = False
            for job in queue:
                cands = cands_of[job.task]
                cur = alloc.get(job.jid, 0)
                for c in cands:
                    if c > cur:
                        if c - cur <= left:
                            alloc[job.jid] = c
                            left -= c - cur
                            bumped = True
                        break

        resize: Dict[int, int] = {}
        starts: Dict[int, int] = {}
        RUN = JobState.RUNNING
        for job in queue:
            a = alloc.get(job.jid, 0)
            if job.state is RUN:
                if a != job.dop:
                    resize[job.jid] = a
            elif a > 0:
                starts[job.jid] = a
        if resize or starts:
            sim.resize(partition, resize, starts)

    def _ads_quota(self, job, cap: int, now: float) -> int:
        pol = self.pol
        cands = pol._cands[job.task]
        if not pol.quota_control:
            fit = [c for c in cands if c <= cap]
            return max(fit) if fit else 0
        # _target + fit_quota inlined (candidate tuples are identical
        # objects to the policy's cache, so the ladder memo is shared
        # with any nested real-policy pass)
        tgt = job.sub_ddl
        if pol.slack_sharing:
            eff = job.e2e_ddl - pol._down.get(job.task, 0.0)
            if eff > tgt:
                tgt = eff
        lad = job._ladder
        if lad is None or lad[0] is not cands:
            tf = self.tf
            lad = job._ladder = (
                cands,
                tuple(job.duration(c, tf) for c in cands),
            )
        durs = lad[1]
        slack = tgt - now
        rem = 1.0 - job.progress
        pick = 0
        i = 0
        for c in cands:
            if c > cap:
                break
            pick = c
            if rem * durs[i] <= slack:
                return c
            i += 1
        return pick

    def _ads_empty_ready(self, part, partition, now, tf, pol, jobs) -> None:
        """The scalar ``_schedule`` body specialised to an empty
        admitted-ready list: the start loop and ``blocked`` are
        vacuous, so ChkTrigger reduces to the at-risk scan and Quota
        Control (if it fires) can only resize running jobs (shrinks
        need ``blocked``; starts need ready jobs).  Each exit stores
        the earliest time any of the evaluated inequalities can flip.
        """
        cmax = pol._cmax
        slack_sharing = pol.slack_sharing
        down = pol._down
        at_risk = False
        min_thr = math.inf
        for jid in part.running:
            job = jobs[jid]
            if cmax[job.task] <= job.dop:
                continue
            # Per-rate-epoch margin memo.  The scalar scan evaluates
            # ``now + (1-progress)*d > tgt`` with progress *stale*
            # (last updated at the job's own event, ``last_t``), so the
            # scan value decays linearly between the job's events —
            # what IS constant per rate epoch is ``M = tgt - projected
            # finish`` with the projection anchored at ``last_t``.  The
            # memo stores ``(gen, M)``; a read reconstructs the scan
            # value as ``M - (now - last_t)`` and trusts its sign only
            # outside a 1e-6 band around zero (reconstruction and
            # stepwise-progress float drift are orders of magnitude
            # below the band); inside the band it falls through to the
            # scalar expression verbatim.
            gen = job.gen
            mg = job._margin
            if mg is not None and mg[0] == gen:
                mm = mg[1]
                m = mm - (now - job.last_t)
                if m > 1e-6:
                    thr = (job.last_t + mm) - 1e-6
                    if thr < min_thr:
                        min_thr = thr
                    continue
                if m < -1e-6:
                    at_risk = True
                    break
            tgt = job.sub_ddl
            if slack_sharing:
                eff = job.e2e_ddl - down.get(job.task, 0.0)
                if eff > tgt:
                    tgt = eff
            c = job.dop
            memo = job._dur
            if memo is None:
                memo = job._dur = {}
            d = memo.get(c)
            if d is None:
                d = memo[c] = (
                    job.work_flops / (c * tf)
                    + job.io_s
                    + job.sync_s * (c - 1)
                )
            proj = (1.0 - job.progress) * d
            job._margin = (gen, (tgt - proj) - job.last_t)
            if now + proj > tgt:
                at_risk = True
                break
            thr = (tgt - proj) - 1e-6
            if thr < min_thr:
                min_thr = thr
        if not at_risk:
            self._quiet[partition] = min_thr
            return

        # ChkTrigger fired: run the start-less Quota Control pass.  No
        # horizon is cached here — pick thresholds are not monotone
        # once progress advances (a smaller candidate's ``rem*d``
        # shrinks faster than slack), so only the exact pass is safe.
        self._quiet[partition] = None
        queue = [jobs[jid] for jid in part.running]
        queue.sort(key=_ddl_key)
        cap_full = part.capacity
        cap_left = cap_full
        want: Dict[int, int] = {}
        quota = self._ads_quota
        for job in queue:
            c = quota(job, cap_left, now)
            if c == 0:
                c = min(job.dop, cap_left)
            want[job.jid] = c
            cap_left -= c

        resize: Dict[int, int] = {}
        gate = pol.realloc_gate
        n_running = len(queue)
        tasks_map = self.sim.wf.tasks
        realloc_latency = self.sim.hw.realloc_latency
        for job in queue:
            c = want[job.jid]
            if c == job.dop or c == 0:
                continue
            if c > job.dop:
                per_tile = tasks_map[job.task].checkpoint_bytes
                stall = realloc_latency(per_tile * abs(c - job.dop), cap_full)
                benefit = job.remaining(job.dop, tf) - job.remaining(c, tf)
                cost = stall * max(1, n_running) * gate
                if benefit > cost:
                    resize[job.jid] = c
            # shrink requires a blocked job — none without ready jobs

        if resize:
            self.sim.resize(partition, resize, {})

    def _ads_schedule(self, partition: int) -> None:
        sim = self.sim
        now = sim.now
        # Quiet horizon: a non-None entry proves the last pass saw no
        # admissible ready job and no at-risk running job, and that
        # nothing observable changed since — every event that can admit
        # a job or perturb running state resets the entry *before* its
        # scheduling point (see advance_until), so the skip is exactly
        # the no-op the scalar engine would re-derive.
        q = self._quiet[partition]
        if q is not None and now < q:
            return
        part = sim.parts[partition]
        if part.stalled:
            return
        tf = self.tf
        pol = self.pol
        jobs = sim.jobs
        quota = self._ads_quota

        rs = sim._ready_sets[partition]
        if pol.admission:
            lim = now + 1e-12
            ready = [j for j in rs if j.ert <= lim] if rs else []
        else:
            ready = list(rs)

        if not ready:
            # the dominant case: nothing admissible.  The start loop
            # and ``blocked`` are vacuous, so only ChkTrigger's at-risk
            # scan (and, if it fires, a start-less Quota Control pass)
            # can matter — and if no job is at risk the pass is a no-op
            # with a provable quiet horizon (see class docstring).
            self._ads_empty_ready(part, partition, now, tf, pol, jobs)
            return
        self._quiet[partition] = None
        running = [jobs[jid] for jid in part.running]

        # fast path: start ready jobs at their quota (scheduler._schedule)
        ready.sort(key=_ddl_key)
        drop_hard = self.drop_hard
        started = True
        while started:
            started = False
            free = part.capacity - part.alloc
            for job in ready:
                c = quota(job, free, now)
                if c > 0:
                    self._start(job, c)
                    if drop_hard:
                        self._arm(partition, job.e2e_ddl, job.jid)
                    ready.remove(job)
                    started = True
                    break

        # ChkTrigger
        free = part.capacity - part.alloc
        cap_full = part.capacity
        blocked = [j for j in ready if quota(j, cap_full, now) > free]
        at_risk = False
        cmax = pol._cmax
        slack_sharing = pol.slack_sharing
        down = pol._down
        for job in running:
            if cmax[job.task] <= job.dop:
                continue
            # same per-rate-epoch margin memo as _ads_empty_ready
            gen = job.gen
            mg = job._margin
            if mg is not None and mg[0] == gen:
                m = mg[1] - (now - job.last_t)
                if m > 1e-6:
                    continue
                if m < -1e-6:
                    at_risk = True
                    break
            tgt = job.sub_ddl
            if slack_sharing:
                eff = job.e2e_ddl - down.get(job.task, 0.0)
                if eff > tgt:
                    tgt = eff
            # job.remaining(job.dop, tf) inlined (running jobs are
            # never sensors; dop >= 1 while running)
            c = job.dop
            memo = job._dur
            if memo is None:
                memo = job._dur = {}
            d = memo.get(c)
            if d is None:
                d = memo[c] = (
                    job.work_flops / (c * tf)
                    + job.io_s
                    + job.sync_s * (c - 1)
                )
            proj = (1.0 - job.progress) * d
            job._margin = (gen, (tgt - proj) - job.last_t)
            if now + proj > tgt:
                at_risk = True
                break
        if not blocked and not at_risk:
            return

        # Quota Control pass
        queue = running + ready
        queue.sort(key=_ddl_key)
        cap_left = cap_full
        want: Dict[int, int] = {}
        RUN = JobState.RUNNING
        for job in queue:
            c = quota(job, cap_left, now)
            if job.state is RUN and c == 0:
                c = min(job.dop, cap_left)
            want[job.jid] = c
            cap_left -= c

        # apply with benefit/cost gating
        resize: Dict[int, int] = {}
        starts: Dict[int, int] = {}
        n_running = len(running)
        gate = pol.realloc_gate
        tasks_map = sim.wf.tasks
        realloc_latency = sim.hw.realloc_latency
        for job in queue:
            c = want[job.jid]
            if job.state is RUN:
                if c == job.dop or c == 0:
                    continue
                per_tile = tasks_map[job.task].checkpoint_bytes
                stall = realloc_latency(per_tile * abs(c - job.dop), cap_full)
                if c > job.dop:
                    benefit = job.remaining(job.dop, tf) - job.remaining(c, tf)
                    cost = stall * max(1, n_running) * gate
                    if benefit > cost:
                        resize[job.jid] = c
                else:
                    if blocked:
                        resize[job.jid] = c
            elif c > 0:
                starts[job.jid] = c

        if resize or starts:
            part_running = part.running
            freed = 0
            for j, d in resize.items():
                freed += part_running[j] - d
            avail = (part.capacity - part.alloc) + freed
            for jid in sorted(starts, key=lambda j: jobs[j].sub_ddl):
                if starts[jid] > avail:
                    starts.pop(jid)
                else:
                    avail -= starts[jid]
            sim.resize(partition, resize, starts)
            if drop_hard:
                for jid in starts:
                    self._arm(partition, jobs[jid].e2e_ddl, jid)

    # -- fused dispatch loop ---------------------------------------------
    def advance_until(self, t_hi: float) -> None:
        sim = self.sim
        heap = sim._heap
        jobs = sim.jobs
        parts = sim.parts
        end_t = sim._end_t
        pop = heapq.heappop
        push = heapq.heappush
        pk = self.pol_kind
        elastic = self.elastic
        drop_on_subddl = self.drop_on_subddl
        drop_hard = self.drop_hard
        RUN = JobState.RUNNING
        READY = JobState.READY
        DONE = JobState.DONE
        DROPPED = JobState.DROPPED
        floor = math.floor
        quiet = self._quiet
        n_parts = len(quiet)
        n_chunks = sim.cfg.n_chunks
        ads_admission = self.ads_admission
        ads_sched = self._ads_schedule
        tp_realloc = self._tp_reallocate
        cyc_start = self._cyc_try_start
        finish = self._finish
        rsets = sim._ready_sets

        while heap:
            t = heap[0][0]
            if t > t_hi:
                break
            t, _, kind, payload = pop(heap)
            sim.now = t

            if kind == "finish":
                jid, gen = payload
                job = jobs[jid]
                if job.gen != gen or job.state is not RUN:
                    continue
                dt = t - job.last_t
                if dt > 0 and job.rate > 0:
                    p = job.progress + dt * job.rate
                    job.progress = p if p < 1.0 else 1.0
                job.last_t = t
                jp = job.partition
                if pk == _POL_ADS:
                    rs_jp = rsets[jp]
                    n0 = len(rs_jp)
                finish(job)
                if sim._drain_watch is not None:
                    sim.policy.on_forecast(sim, sim._drain_watch, t)
                    # a drain delivery can commit a staged hot-swap
                    for i in range(n_parts):
                        quiet[i] = None
                if pk == _POL_ADS:
                    # A finish removes one running job (the min over the
                    # survivors' at-risk horizons can only rise) and
                    # frees tiles (invisible to an empty-ready pass), so
                    # a valid quiet horizon survives it — unless the
                    # finish released a same-partition successor, or an
                    # already-queued ready job sits inside the 1e-12
                    # admission window ahead of its pending ert event.
                    q = quiet[jp]
                    if q is None or t >= q or len(rs_jp) != n0:
                        quiet[jp] = None
                        ads_sched(jp)
                    else:
                        lim = t + 1e-12
                        for j in rs_jp:
                            if j.ert <= lim:
                                quiet[jp] = None
                                ads_sched(jp)
                                break
                elif pk == _POL_TP:
                    tp_realloc(jp)
                else:
                    cyc_start(jp)

            elif kind == "chunk":
                # second in the chain: chunk boundaries are the most
                # frequent event for the ads_tile lanes (the only fused
                # policy with ``uses_chunk_points``); quiet check
                # inlined to spare the call on the dominant skip path
                jid, gen = payload
                job = jobs[jid]
                if job.gen != gen or job.state is not RUN:
                    continue
                dt = t - job.last_t
                if dt > 0 and job.rate > 0:
                    p = job.progress + dt * job.rate
                    job.progress = p if p < 1.0 else 1.0
                job.last_t = t
                nxt = floor(job.progress * n_chunks + 1e-9) + 1
                if nxt < n_chunks and job.rate > 0:
                    t2 = t + (nxt / n_chunks - job.progress) / job.rate
                    if t2 <= end_t:
                        sim._seq = seq = sim._seq + 1
                        push(heap, (t2, seq, "chunk", (job.jid, job.gen)))
                jp = job.partition
                q = quiet[jp]
                if q is None or t >= q:
                    ads_sched(jp)

            elif kind == "ready":
                job = jobs[payload[0]]
                if job.state is not READY:
                    continue
                partition = job.partition
                if pk == _POL_ADS:
                    if drop_hard:
                        self._arm(partition, job.e2e_ddl, job.jid)
                    if not ads_admission or job.ert <= t + 1e-12:
                        # the arrival is admissible right away
                        quiet[partition] = None
                    ads_sched(partition)
                elif pk == _POL_TP:
                    if drop_on_subddl:
                        self._arm(partition, job.sub_ddl, job.jid)
                    elif drop_hard:
                        self._arm(partition, job.e2e_ddl, job.jid)
                    self._tp_reallocate(partition)
                else:
                    if not elastic:
                        self._arm(partition, job.sub_ddl, job.jid)
                    self._cyc_try_start(partition)

            elif kind == "ert":
                job = jobs[payload[0]]
                if job.state is not READY:
                    continue
                # "ert" is a scheduling point for ads/cyc only
                # (tp_driven's on_point ignores it)
                if pk == _POL_ADS:
                    jp = job.partition
                    quiet[jp] = None  # the job just crossed admission
                    ads_sched(jp)
                elif pk == _POL_CYC:
                    cyc_start(job.partition)

            elif kind == "sensor":
                job = jobs[payload[0]]
                if job.drop_at_release:
                    sim.terminate(job, "sensor_dropout")
                    for i in range(n_parts):
                        quiet[i] = None
                    continue
                job.state = RUN
                job.start_t = t
                t2 = t + job.io_s
                if t2 <= end_t:
                    sim._seq = seq = sim._seq + 1
                    push(heap, (t2, seq, "sensor_done", (job.jid,)))

            elif kind == "sensor_done":
                finish(jobs[payload[0]])

            elif kind == "timer":
                pid, jid = payload
                job = jobs[jid] if jid >= 0 else None
                if job is not None and (job.state is DONE or job.state is DROPPED):
                    continue
                if job is None:
                    continue
                if pk == _POL_ADS:
                    if drop_hard and t >= job.e2e_ddl - 1e-12:
                        sim.terminate(job, "e2e_deadline")
                        # the nested "drop" point ran the real policy
                        for i in range(n_parts):
                            quiet[i] = None
                elif pk == _POL_TP:
                    if drop_on_subddl and t >= job.sub_ddl - 1e-12:
                        sim.terminate(job, "subddl_drop")
                    elif drop_hard and t >= job.e2e_ddl - 1e-12:
                        sim.terminate(job, "e2e_deadline")
                else:
                    if not elastic:
                        if t >= job.sub_ddl - 1e-12:
                            sim.terminate(job, "budget_overrun")
                    elif drop_hard and t >= job.e2e_ddl - 1e-12:
                        sim.terminate(job, "e2e_deadline")
                    self._cyc_try_start(pid)

            elif kind == "resume":
                part = parts[payload[0]]
                if part.stall_end > t + 1e-12:
                    continue
                self._touch_part(part, t)
                part.stalled = False
                for jid in list(part.running):
                    job = jobs[jid]
                    dt = t - job.last_t
                    if dt > 0 and job.rate > 0:
                        p = job.progress + dt * job.rate
                        job.progress = p if p < 1.0 else 1.0
                    job.last_t = t
                    self._rate(job)
                # the stall froze progress while time advanced, so the
                # cached at-risk horizon no longer holds
                pidx = part.idx
                quiet[pidx] = None
                if pk == _POL_ADS:
                    ads_sched(pidx)
                elif pk == _POL_TP:
                    tp_realloc(pidx)
                else:
                    cyc_start(pidx)

            elif kind == "forecast":
                sim.policy.on_forecast(sim, payload[0], t)
                for i in range(n_parts):
                    quiet[i] = None

            elif kind == "mode_change":
                mode = payload[0]
                for part in parts:
                    sim._touch(part)
                sim._mode_now = mode
                sim.n_mode_switches += 1
                sim.policy.on_mode_change(sim, mode, t)
                for i in range(n_parts):
                    quiet[i] = None


# ---------------------------------------------------------------------------
# batch-shared precomputations
# ---------------------------------------------------------------------------
def _prefill_ladders(sims: Sequence[Simulator]) -> None:
    """Prefill every lane's per-job DoP duration ladders from
    vectorized per-task kernels.

    The scalar engine computes each ladder lazily per candidate (the
    policies' FitQuota/EDF walks); here one ``(n_jobs, n_cands)`` array
    expression per task replaces those scalar evaluations.  The
    expression tree matches ``Job.duration`` exactly (``work / (c *
    tile_flops) + io + sync * (c - 1)`` with Python-float ``c *
    tile_flops``), so the prefilled values are bit-identical to what
    the lazy path would produce — lanes whose candidate tuples differ
    from the policy cache (or change after a hot-swap re-setup) simply
    fall back to the lazy path via the ladder's identity check.
    """
    base = sims[0]
    jids_by_task: Dict[str, List[int]] = {}
    for job in base.jobs:
        if not job.is_sensor:
            jids_by_task.setdefault(job.task, []).append(job.jid)

    for sim in sims:
        pol = sim.policy
        cands_of = getattr(pol, "_cands", None)
        trace = sim.cfg.trace
        if not cands_of or trace is None:
            continue
        tf = sim.hw.tile_flops
        jobs = sim.jobs
        W, IO = trace.work, trace.io
        for task, jids in jids_by_task.items():
            cands = cands_of.get(task)
            if not cands:
                continue
            ix = np.asarray(jids, dtype=np.intp)
            w, io = W[ix], IO[ix]
            sync = jobs[jids[0]].sync_s
            cols = [(w / (c * tf) + io + sync * (c - 1)).tolist() for c in cands]
            rows = zip(*cols)
            for jid, row in zip(jids, rows):
                jobs[jid]._ladder = (cands, row)


# ---------------------------------------------------------------------------
# lockstep driver
# ---------------------------------------------------------------------------
def _windows(sim: Simulator) -> List[float]:
    """Lockstep window boundaries: one per scenario segment seam, plus
    the horizon.  Windows only partition each lane's event sequence —
    events are still processed strictly in per-lane heap order — so
    any boundary set is semantics-preserving; seams are where lane
    state naturally synchronizes."""
    dur = sim.cfg.duration_s
    scen = sim.cfg.scenario
    cuts = set()
    if scen is not None:
        for t, _m in scen.boundaries():
            if 0.0 < t < dur:
                cuts.add(t)
    return sorted(cuts) + [dur]


def run_batch(sims: Sequence[Simulator]) -> List[SimReport]:
    """Advance B simulator lanes of one scenario skeleton in lockstep
    and return their reports (bit-identical to ``sim.run()`` per lane).

    Preconditions: every lane shares the first lane's skeleton (same
    workflow structure, scenario, horizon) — seeds, schedules, policies
    and replanners may differ per lane.  Lanes the fused core supports
    run fused; the rest fall back to the scalar engine's own step
    driver inside the same window loop.
    """
    if not sims:
        return []
    base = sims[0]
    for sim in sims[1:]:
        if sim._sink_src is not base._sink_src:
            raise ValueError(
                "run_batch lanes must share one scenario skeleton "
                "(same workflow/scenario/horizon)"
            )

    lanes = []
    for sim in sims:
        sim._prime()
        lanes.append(_FastLane(sim) if fast_lane_supported(sim) else _ScalarLane(sim))

    # batch-shared statics: chain expectations (once) + duration ladders
    shared = Simulator._chain_expectations(base)
    for sim in sims:
        if isinstance(sim, LaneSimulator):
            sim._shared_expectations = shared
    _prefill_ladders(sims)

    with metrics.phase("engine_run"):
        for w in _windows(base):
            for lane in lanes:
                lane.advance_until(w)
    return [sim._finalize() for sim in sims]


# ---------------------------------------------------------------------------
# report equivalence
# ---------------------------------------------------------------------------
def report_digest(report: SimReport) -> dict:
    """Canonical comparable form of a :class:`SimReport`: every numeric
    field verbatim (floats kept exact for bit-identity checks), NaNs
    mapped to a sentinel so equality is well-defined."""

    def _f(x):
        if isinstance(x, float) and math.isnan(x):
            return "nan"
        return x

    fc = report.forecast
    out = {
        "duration_s": report.duration_s,
        "total_tiles": report.total_tiles,
        "effective_frac": report.effective_frac,
        "realloc_frac": report.realloc_frac,
        "idle_frac": report.idle_frac,
        "dropped_work_frac": report.dropped_work_frac,
        "n_realloc": report.n_realloc,
        "realloc_bytes": report.realloc_bytes,
        "n_jobs": report.n_jobs,
        "n_dropped": report.n_dropped,
        "task_miss_rate": report.task_miss_rate,
        "chain_count": dict(report.chain_count),
        "chain_violations": dict(report.chain_violations),
        "chain_p99_s": {k: _f(v) for k, v in report.chain_p99_s.items()},
        "chain_latencies": {k: tuple(v) for k, v in report.chain_latencies.items()},
        "decision_ratios": tuple(report.decision_ratios),
        "mode_stats": {
            m: (
                s.mode,
                s.span_s,
                s.n_completed,
                s.n_violations,
                _f(s.p99_s),
                s.effective_frac,
                s.realloc_frac,
            )
            for m, s in report.mode_stats.items()
        },
        "n_mode_switches": report.n_mode_switches,
        "forecast": None if fc is None else dataclasses.astuple(fc),
        "tiles_used": report.tiles_used,
        "tiles_reserved_mean": report.tiles_reserved_mean,
    }
    # degraded-operation section only when present, so digests of
    # degradation-free runs are unchanged from before the degradation
    # seams existed
    if report.degrade:
        out["degrade"] = tuple(
            tuple(_f(v) for v in dataclasses.astuple(st))
            for st in report.degrade
        )
    return out


def reports_identical(a: SimReport, b: SimReport) -> bool:
    """Bit-identity predicate between two reports."""
    return report_digest(a) == report_digest(b)
