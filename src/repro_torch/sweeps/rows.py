"""Typed sweep rows.

:class:`SweepRow` is the typed replacement for the ad-hoc dict that
``repro_torch.scenarios.runner.summarize`` used to build inline.  The dict
shape is load-bearing — committed benchmark JSON files, the cache files
under a sweep campaign's result store, and ``benchmarks.make_tables``
all consume it — so :meth:`SweepRow.to_dict` reproduces it
byte-for-byte: same keys, same order, same value types.  The dataclass
exists so new code (the sweep service, reducers, tests) gets attribute
access and a stable schema instead of string indexing.

This module is deliberately dependency-light (no imports from
``repro_torch.scenarios``): it is imported *by* the scenario runner.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

__all__ = ["SweepRow"]


@dataclasses.dataclass
class SweepRow:
    """One (scenario, policy, seed) cell of a Monte-Carlo sweep.

    Field order mirrors the historical ``summarize()`` dict exactly;
    :meth:`to_dict` relies on it.
    """

    scenario: str
    script: str
    policy: str
    replan: bool
    replan_mode: str
    seed: int
    forecast: Optional[Dict[str, object]]
    violation_rate: float
    task_miss_rate: float
    effective_frac: float
    realloc_frac: float
    n_realloc: int
    n_mode_switches: int
    tiles_used: int
    tiles_reserved_mean: float
    target_miss: Optional[float]
    #: deadline-miss decomposition (recorded runs only, else None)
    attribution: Optional[Dict[str, object]]
    per_mode: Dict[str, Dict[str, object]]

    @classmethod
    def from_report(cls, spec, report) -> "SweepRow":
        """Flatten one run into a row.

        ``spec`` is any object with the scenario-runner spec fields
        (``scenario``, ``policy``, ``replan``, ``replan_mode``,
        ``seed``, ``target_miss``); ``report`` is a
        :class:`~repro_torch.core.sim.SimReport`.
        """
        fc = report.forecast
        return cls(
            scenario=spec.scenario.name,
            script=spec.scenario.to_string(),
            policy=spec.policy,
            replan=spec.replan,
            replan_mode=spec.replan_mode,
            seed=spec.seed,
            forecast=None if fc is None else {
                "n_forecasts": fc.n_forecasts,
                "n_preswaps": fc.n_preswaps,
                "n_blends": fc.n_blends,
                "n_hits": fc.n_hits,
                "n_misses": fc.n_misses,
                "n_reverts": fc.n_reverts,
                "hit_rate": fc.hit_rate,
                "prestage_stall_s": fc.prestage_stall_s,
            },
            violation_rate=report.violation_rate,
            task_miss_rate=report.task_miss_rate,
            effective_frac=report.effective_frac,
            realloc_frac=report.realloc_frac,
            n_realloc=report.n_realloc,
            n_mode_switches=report.n_mode_switches,
            tiles_used=report.tiles_used,
            tiles_reserved_mean=report.tiles_reserved_mean,
            target_miss=spec.target_miss,
            attribution=report.attribution,
            per_mode={
                m: {
                    "span_s": s.span_s,
                    "n_completed": s.n_completed,
                    "n_violations": s.n_violations,
                    "violation_rate": s.violation_rate,
                    # None rather than NaN: NaN breaks row equality and JSON
                    "p99_s": None if math.isnan(s.p99_s) else s.p99_s,
                    "effective_frac": s.effective_frac,
                    "realloc_frac": s.realloc_frac,
                }
                for m, s in report.mode_stats.items()
            },
        )

    def to_dict(self) -> Dict[str, object]:
        """The legacy ``summarize()`` dict, byte-for-byte (fresh
        containers, so callers may mutate the result freely)."""
        out: Dict[str, object] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "per_mode":
                v = {m: dict(st) for m, st in v.items()}
            elif f.name in ("forecast", "attribution") and v is not None:
                v = dict(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "SweepRow":
        """Inverse of :meth:`to_dict` (also accepts cache-file JSON)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
