"""Probabilistic latency model (paper §II-C3, Eq. 1).

Two random variables capture runtime variation:

* **F1 — execution variation** ``W_v``: arithmetic workload of task ``v``
  (FLOPs).  Modelled lognormal, parameterised by its mean and the
  p99/mean ratio (the paper cites p99 up to 3.3x the mean [4]).
* **F2 — inter-task interference** ``I_v``: I/O latency under memory
  contention.  Per the paper, a constant component (avg tile-to-MC hop
  latency) plus an M/M/1 queuing component — a *shifted exponential*
  whose tail grows with DRAM utilisation.

Given ``c_v`` tiles and per-tile processing power ``P``::

    L_v(q, c_v) = W_v^(q) / (c_v * P) + I_v^(q)            (Eq. 1)

so ``Pr[L_v <= L_v(q, c_v)] >= q`` — an independent per-task
probabilistic bound.  On top of the paper's form we keep an explicit
DoP-efficiency term ``sync_per_tile_s * (c-1)`` (the "modulo NoC
communication overhead" caveat of §II-C1): it gives every task a
diminishing-returns DoP curve and therefore a finite optimal DoP, which
the multi-version compiler prunes against (§IV-D2).

Scalar quantiles use plain floats (consumed by the offline GHA solver);
sampling draws from an explicit ``torch.Generator`` (used by the
Monte-Carlo tail-composition analysis).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .hardware import HardwareModel
from .workload import SensorTask, Task, Workflow

__all__ = [
    "LogNormal",
    "ShiftedExponential",
    "TaskLatencyProfile",
    "LatencyModel",
    "ndtri",
    "prune_dop_candidates",
    "chain_tail_composition",
]

_Z99 = 2.3263478740408408  # Phi^{-1}(0.99)


@dataclasses.dataclass(frozen=True)
class LogNormal:
    """Lognormal parameterised by (mean, p99/mean ratio)."""

    mean: float
    p99_ratio: float = 1.0

    def __post_init__(self) -> None:
        if self.mean < 0:
            raise ValueError("mean must be >= 0")
        if self.p99_ratio < 1.0:
            raise ValueError("p99_ratio must be >= 1")

    @property
    def sigma(self) -> float:
        if self.p99_ratio <= 1.0 + 1e-12:
            return 0.0
        # p99/mean = exp(z99*s - s^2/2)  =>  s^2 - 2 z99 s + 2 ln r = 0
        lr = math.log(self.p99_ratio)
        disc = _Z99 * _Z99 - 2.0 * lr
        if disc <= 0:  # ratio too extreme for lognormal; saturate
            return _Z99
        return _Z99 - math.sqrt(disc)

    @property
    def mu(self) -> float:
        if self.mean == 0:
            return -math.inf
        return math.log(self.mean) - 0.5 * self.sigma**2

    def quantile(self, q: float) -> float:
        if self.mean == 0:
            return 0.0
        if self.sigma == 0.0:
            return self.mean
        z = float(_ndtri(q))
        return math.exp(self.mu + self.sigma * z)

    def quantiles(self, q: "np.ndarray") -> "np.ndarray":
        """Vectorized :meth:`quantile` over an array of probabilities
        (the batched trace generator's inverse-CDF sampling path)."""
        q = np.asarray(q, dtype=np.float64)
        if self.mean == 0:
            return np.zeros_like(q)
        if self.sigma == 0.0:
            return np.full_like(q, self.mean)
        return np.exp(self.mu + self.sigma * ndtri(q))

    def sample(
        self, gen: torch.Generator, shape: Tuple[int, ...] = ()
    ) -> torch.Tensor:
        """Draw ``shape`` float64 samples on ``gen``'s device."""
        if self.mean == 0:
            return torch.zeros(shape, dtype=torch.float64, device=gen.device)
        z = torch.randn(shape, generator=gen, dtype=torch.float64, device=gen.device)
        return torch.exp(self.mu + self.sigma * z)


@dataclasses.dataclass(frozen=True)
class ShiftedExponential:
    """base + Exp(rate): the M/M/1 sojourn-tail model of the paper."""

    base: float          # seconds (constant hop-latency component)
    rate: float          # 1/seconds; mean queuing delay = 1/rate

    def quantile(self, q: float) -> float:
        if self.rate <= 0:
            return self.base
        return self.base - math.log(max(1.0 - q, 1e-300)) / self.rate

    def quantiles(self, q: "np.ndarray") -> "np.ndarray":
        """Vectorized :meth:`quantile` over an array of probabilities."""
        q = np.asarray(q, dtype=np.float64)
        if self.rate <= 0:
            return np.full_like(q, self.base)
        return self.base - np.log(np.maximum(1.0 - q, 1e-300)) / self.rate

    @property
    def mean(self) -> float:
        return self.base + (1.0 / self.rate if self.rate > 0 else 0.0)

    def sample(
        self, gen: torch.Generator, shape: Tuple[int, ...] = ()
    ) -> torch.Tensor:
        """Draw ``shape`` float64 samples on ``gen``'s device."""
        e = torch.empty(shape, dtype=torch.float64, device=gen.device)
        e.exponential_(generator=gen)
        return self.base + (e / self.rate if self.rate > 0 else torch.zeros_like(e))


# Acklam inverse-normal-CDF coefficients, shared by the scalar fast
# path and the vectorized array path (one implementation of the
# rational approximation; two evaluation strategies).
_NDTRI_A = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
            1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_NDTRI_B = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
            6.680131188771972e01, -1.328068155288572e01)
_NDTRI_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
            -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_NDTRI_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
            3.754408661907416e00)
_NDTRI_PLOW = 0.02425


def _ndtri_tail(x):
    """Tail branch of Acklam's approximation in ``x = sqrt(-2 ln p)``
    (works on floats and on NumPy arrays alike)."""
    c, d = _NDTRI_C, _NDTRI_D
    return (((((c[0] * x + c[1]) * x + c[2]) * x + c[3]) * x + c[4]) * x + c[5]) / \
           ((((d[0] * x + d[1]) * x + d[2]) * x + d[3]) * x + 1)


def _ndtri_central(q):
    """Central branch of Acklam's approximation (floats or arrays)."""
    a, b = _NDTRI_A, _NDTRI_B
    x = q - 0.5
    r = x * x
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * x / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def ndtri(q):
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Accepts a float (returned as ``float``, the offline solvers' scalar
    path) or a NumPy array (returned as ``ndarray``, the batched
    trace-generation path) — both evaluate the same branch polynomials.
    ``q <= 0`` maps to ``-inf`` and ``q >= 1`` to ``+inf``.
    """
    if np.ndim(q) == 0:
        q = float(q)
        if not 0.0 < q < 1.0:
            return -math.inf if q <= 0.0 else math.inf
        if q < _NDTRI_PLOW:
            return float(_ndtri_tail(math.sqrt(-2 * math.log(q))))
        if q > 1 - _NDTRI_PLOW:
            return float(-_ndtri_tail(math.sqrt(-2 * math.log(1 - q))))
        return float(_ndtri_central(q))

    q = np.asarray(q, dtype=np.float64)
    out = np.empty_like(q)
    lo = q <= 0.0
    hi = q >= 1.0
    low_tail = (q < _NDTRI_PLOW) & ~lo
    high_tail = (q > 1 - _NDTRI_PLOW) & ~hi
    central = ~(lo | hi | low_tail | high_tail)
    out[lo] = -np.inf
    out[hi] = np.inf
    if low_tail.any():
        out[low_tail] = _ndtri_tail(np.sqrt(-2.0 * np.log(q[low_tail])))
    if high_tail.any():
        out[high_tail] = -_ndtri_tail(np.sqrt(-2.0 * np.log(1.0 - q[high_tail])))
    if central.any():
        out[central] = _ndtri_central(q[central])
    return out


#: backwards-compatible scalar alias (existing callers import `_ndtri`)
_ndtri = ndtri


@dataclasses.dataclass(frozen=True)
class TaskLatencyProfile:
    """Per-task (W_v, I_v) pair plus the DoP-efficiency term."""

    name: str
    work: LogNormal                 # FLOPs (zero for sensor tasks)
    io: ShiftedExponential          # seconds
    sync_per_tile_s: float = 0.0    # NoC/collective overhead per extra tile
    sensor_latency: Optional[LogNormal] = None  # set for sensor tasks

    @property
    def is_sensor(self) -> bool:
        return self.sensor_latency is not None

    # -- Eq. (1) ----------------------------------------------------------
    def latency_bound(self, q: float, c: int, tile_flops: float) -> float:
        """L_v(q, c_v): the per-task probabilistic latency bound."""
        if self.is_sensor:
            return self.sensor_latency.quantile(q)
        compute = self.work.quantile(q) / (c * tile_flops)
        return compute + self.sync_per_tile_s * (c - 1) + self.io.quantile(q)

    def mean_latency(self, c: int, tile_flops: float) -> float:
        if self.is_sensor:
            return self.sensor_latency.mean
        return (self.work.mean / (c * tile_flops)
                + self.sync_per_tile_s * (c - 1) + self.io.mean)

    def sample_latency(
        self, gen: torch.Generator, c: int, tile_flops: float,
        shape: Tuple[int, ...] = (),
    ) -> torch.Tensor:
        """Draw ``shape`` samples of L_v at DoP ``c`` (work, then io,
        from the one generator's stream)."""
        if self.is_sensor:
            return self.sensor_latency.sample(gen, shape)
        w = self.work.sample(gen, shape)
        i = self.io.sample(gen, shape)
        return w / (c * tile_flops) + self.sync_per_tile_s * (c - 1) + i


def prune_dop_candidates(
    profile: TaskLatencyProfile,
    tile_flops: float,
    candidates: Sequence[int],
    q: float = 0.95,
    improvement_threshold: float = 0.05,
) -> Tuple[int, ...]:
    """Multi-version compilation pruning (§IV-D2): gradually increase the
    tile count from the minimum and prune candidates that do not improve
    latency by at least ``improvement_threshold`` over the previous kept
    candidate."""
    cands = sorted(set(int(c) for c in candidates))
    if not cands:
        raise ValueError("no DoP candidates")
    kept = [cands[0]]
    last = profile.latency_bound(q, cands[0], tile_flops)
    for c in cands[1:]:
        lat = profile.latency_bound(q, c, tile_flops)
        if lat < last * (1.0 - improvement_threshold):
            kept.append(c)
            last = lat
    return tuple(kept)


class LatencyModel:
    """The framework's latency oracle: profiles for every task of a
    workflow on a given hardware model."""

    def __init__(self, profiles: Mapping[str, TaskLatencyProfile], hw: HardwareModel):
        self.profiles: Dict[str, TaskLatencyProfile] = dict(profiles)
        self.hw = hw
        # (task, q, c) -> L_v(q, c): profiles are frozen, so bounds are
        # immutable per model.  best_dop / min_dop_for_budget / the GHA
        # phases and the portfolio autotuner recompute the same bounds
        # many times per compile; the cache makes repeats a dict hit.
        self._bound_cache: Dict[Tuple[str, float, int], float] = {}
        # (task, q, candidate tuple) -> bound tuple: the frontier search
        # walks whole candidate ladders per (task, q); see bound_ladder
        self._ladder_cache: Dict[Tuple[str, float, tuple], Tuple[float, ...]] = {}
        # task tuple -> flattened per-task parameter arrays for the
        # vectorized bound_batch path (see _batch_params)
        self._batch_cache: Dict[Tuple[str, ...], tuple] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_workflow(
        cls,
        wf: Workflow,
        hw: HardwareModel,
        p99_ratio: float = 3.3,
        dram_utilization: float = 0.5,
        base_io_s: float = 5e-6,
        sensor_p99_ratio: float = 1.5,
    ) -> "LatencyModel":
        """Build profiles from the workflow's per-task annotations.

        The M/M/1 queuing rate for task v shrinks as total DRAM pressure
        grows: ``rate = k_v * (1 - rho)`` with ``k_v`` set so that a task
        demanding a larger bandwidth share queues longer (its requests
        arrive faster).  This mirrors the paper's BookSim-fitted I_v whose
        tail grows with DRAM utilisation.
        """
        rho = min(max(dram_utilization, 0.0), 0.99)
        profiles: Dict[str, TaskLatencyProfile] = {}
        for name, task in wf.tasks.items():
            if isinstance(task, SensorTask):
                profiles[name] = TaskLatencyProfile(
                    name=name,
                    work=LogNormal(0.0),
                    io=ShiftedExponential(0.0, 0.0),
                    sensor_latency=LogNormal(task.mean_latency_s, sensor_p99_ratio),
                )
                continue
            # queuing: heavier-bandwidth tasks see longer queues
            bw_share = max(task.avg_bw_frac, 0.005)
            service_rate = 1.0 / base_io_s
            rate = service_rate * (1.0 - rho) / (1.0 + 10.0 * bw_share)
            # sync term: moving one job's activation set across one more
            # tile costs checkpoint_bytes/100 over a NoC link
            sync = (0.01 * task.checkpoint_bytes) / hw.noc_link_bytes_per_s
            profiles[name] = TaskLatencyProfile(
                name=name,
                work=LogNormal(task.mean_flops, p99_ratio),
                io=ShiftedExponential(base_io_s, rate),
                sync_per_tile_s=sync,
            )
        return cls(profiles, hw)

    # -- queries -----------------------------------------------------------
    def bound(self, task: str, q: float, c: int) -> float:
        """Cached L_v(q, c) (Eq. 1); see ``_bound_cache``."""
        key = (task, q, c)
        hit = self._bound_cache.get(key)
        if hit is None:
            hit = self.profiles[task].latency_bound(q, c, self.hw.tile_flops)
            self._bound_cache[key] = hit
        return hit

    def mean(self, task: str, c: int) -> float:
        return self.profiles[task].mean_latency(c, self.hw.tile_flops)

    def bound_ladder(
        self, task: str, q: float, cands: Tuple[int, ...]
    ) -> Tuple[float, ...]:
        """L_v(q, c) for a whole DoP-candidate tuple at one (task, q).

        The per-(task, q) quantiles ``W_v^(q)`` and ``I_v^(q)`` are
        computed once and the ladder over ``c`` is filled arithmetically
        — the autotuner's frontier search and the solvers' candidate
        walks re-evaluate the same ladders constantly, and computing
        ``ndtri`` per rung was the dominant cost.  Memoized per
        ``(task, q, cands)``.
        """
        key = (task, q, cands)
        hit = self._ladder_cache.get(key)
        if hit is not None:
            return hit
        prof = self.profiles[task]
        if prof.is_sensor:
            lat = prof.sensor_latency.quantile(q)
            out = tuple(lat for _ in cands)
        else:
            wq = prof.work.quantile(q)
            iq = prof.io.quantile(q)
            tf = self.hw.tile_flops
            sync = prof.sync_per_tile_s
            out = tuple(wq / (c * tf) + sync * (c - 1) + iq for c in cands)
        self._ladder_cache[key] = out
        bc = self._bound_cache
        for c, l in zip(cands, out):
            bc.setdefault((task, q, c), l)
        return out

    def _batch_params(self, tasks: Tuple[str, ...]) -> tuple:
        """Per-task distribution parameters flattened to arrays for
        :meth:`bound_batch` (cached per task tuple)."""
        hit = self._batch_cache.get(tasks)
        if hit is not None:
            return hit
        n = len(tasks)
        mean = np.empty(n)
        mu = np.empty(n)
        sigma = np.empty(n)
        io_base = np.empty(n)
        io_rate = np.empty(n)
        sync = np.empty(n)
        sensor = np.zeros(n, dtype=bool)
        for i, t in enumerate(tasks):
            prof = self.profiles[t]
            dist = prof.sensor_latency if prof.is_sensor else prof.work
            mean[i] = dist.mean
            mu[i] = dist.mu if dist.mean > 0 else 0.0
            sigma[i] = dist.sigma
            io_base[i] = prof.io.base
            io_rate[i] = prof.io.rate
            sync[i] = prof.sync_per_tile_s
            sensor[i] = prof.is_sensor
        params = (mean, mu, sigma, io_base, io_rate, sync, sensor)
        self._batch_cache[tasks] = params
        return params

    def bound_batch(
        self, tasks: Tuple[str, ...], q: float, dops: "np.ndarray"
    ) -> "np.ndarray":
        """Vectorized Eq. (1) across many tasks at one quantile.

        ``dops`` aligns with ``tasks`` (ignored for sensor entries,
        which evaluate their sensor-latency quantile).  This is the
        frontier search's inner loop: predicting a schedule's E2E miss
        probability bisects over ``q`` with the chain's task set fixed,
        so per-call work must be a handful of array ops, not a Python
        loop over :meth:`bound`.
        """
        mean, mu, sigma, io_base, io_rate, sync, sensor = self._batch_params(tasks)
        z = float(_ndtri(q))
        with np.errstate(invalid="ignore"):
            wq = np.where(sigma > 0.0, np.exp(mu + sigma * z), mean)
        wq = np.where(mean <= 0.0, 0.0, wq)
        c = np.maximum(np.asarray(dops, dtype=np.float64), 1.0)
        iq = io_base + np.where(
            io_rate > 0.0,
            -math.log(max(1.0 - q, 1e-300)) / np.maximum(io_rate, 1e-300),
            0.0,
        )
        dnn = wq / (c * self.hw.tile_flops) + sync * (c - 1.0) + iq
        return np.where(sensor, wq, dnn)

    def best_dop(self, task: Task, q: float, cap: Optional[int] = None) -> int:
        """Smallest-latency DoP among the (pruned) candidates."""
        cands = task.dop_candidates(cap)
        ladder = self.bound_ladder(task.name, q, cands)
        best = min(range(len(cands)), key=lambda i: ladder[i])
        return cands[best]

    def min_dop_for_budget(
        self, task: Task, q: float, budget_s: float, cap: Optional[int] = None
    ) -> Optional[int]:
        """Smallest DoP whose q-quantile bound fits in ``budget_s``
        (the FitQuota primitive of Alg. 2); None if infeasible."""
        cands = task.dop_candidates(cap)
        for c, l in zip(cands, self.bound_ladder(task.name, q, cands)):
            if l <= budget_s:
                return c
        return None

    def pruned_candidates(
        self, task: Task, q: float = 0.95, threshold: float = 0.05
    ) -> Tuple[int, ...]:
        return prune_dop_candidates(
            self.profiles[task.name], self.hw.tile_flops,
            task.dop_candidates(), q, threshold,
        )


def chain_tail_composition(
    model: LatencyModel,
    chain_tasks: Sequence[str],
    dops: Mapping[str, int],
    q: float,
    num_samples: int = 20000,
    seed: int = 0,
    device: str = "cpu",
) -> Dict[str, float]:
    """Quantify the *tail-composition headroom* (paper §II-C3 scope note).

    Summing per-task q-quantile budgets overestimates the observed E2E
    q-quantile because tail events from different tasks rarely align in
    the same chain instance.  Returns the conservative envelope
    ``sum_q`` = sum of per-task bounds, the Monte-Carlo E2E quantile
    ``mc_q``, and headroom = 1 - mc_q/sum_q.

    One batched sample per task from a generator seeded with ``seed``,
    summed; ``device`` places the draws (a host-side analysis, so the
    CPU is its default).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = torch.zeros((num_samples,), dtype=torch.float64, device=device)
    sum_q = 0.0
    tf = model.hw.tile_flops
    for name in chain_tasks:
        prof = model.profiles[name]
        c = int(dops.get(name, 1))
        total = total + prof.sample_latency(gen, c, tf, (num_samples,))
        sum_q += prof.latency_bound(q, c, tf)
    mc_q = float(torch.quantile(total, q))
    mc_mean = float(torch.mean(total))
    return {
        "sum_of_quantiles_s": float(sum_q),
        "mc_quantile_s": mc_q,
        "mc_mean_s": mc_mean,
        "headroom": 1.0 - mc_q / sum_q if sum_q > 0 else 0.0,
    }
