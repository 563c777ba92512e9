"""Batched trace materialization and report digests.

This is the trace half of the reference's batched engine:
:func:`sample_trace_batch` evaluates the counter-based stream contract
once for all seeds as ``(B, n)`` array ops.  The seed only enters the
scalar key fold, so a ``(B, 1)`` seed-hash column broadcast against the
``(n,)`` per-job key arrays yields every lane's uniforms in one pass.
Each host (NumPy) row is bit-identical to
:func:`~repro_torch.core.sim.trace.sample_trace` for that seed.

``sample_trace_batch(..., device=...)`` runs the same pass as torch
ops on that device (the SoA backend's path).  The splitmix64 integer
pipeline is carried in ``int64``: multiplies wrap, a logical right
shift is an arithmetic shift followed by a mask, and constants above
2**63 are written as their two's-complement values.  So its uniforms
are bit-identical to the NumPy path; the float64 quantile transforms
after them may differ in the last ulp.

The lockstep engine (``LaneSimulator``, ``run_batch`` and the fused
lanes) is not part of this module yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

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
from .engine import SimReport
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
