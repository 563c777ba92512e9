"""Streaming sweep aggregation.

:class:`SweepReducer` is the online form of the historical batch
``aggregate_sweep``: feed it rows one at a time (``update``) and ask
for the per-policy aggregate at any point (``result``).  State is O(
policies x modes), independent of the number of rows, so a 100k-drive
campaign can aggregate while it streams out of the executor instead of
materializing every row first.  The batch function
``repro_torch.scenarios.aggregate_sweep`` is now a thin wrapper over this
class, so the two are equal by construction.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

__all__ = ["SweepReducer"]


class _PolicyAccumulator:
    """Running sums for one policy."""

    __slots__ = (
        "n", "violation_sum", "miss_sum", "realloc_sum", "tiles_used_max",
        "per_mode", "att_n", "att_late", "att_dropped", "att_degraded",
        "att_lateness", "att_components",
    )

    def __init__(self) -> None:
        self.n = 0
        self.violation_sum = 0.0
        self.miss_sum = 0.0
        self.realloc_sum = 0.0
        self.tiles_used_max = 0
        # mode -> [viol_sum, viol_n, p99_sum, p99_n, realloc_sum, realloc_n]
        self.per_mode: Dict[str, List[float]] = {}
        self.att_n = 0
        self.att_late = 0
        self.att_dropped = 0
        self.att_degraded = 0
        self.att_lateness = 0.0
        self.att_components = {
            "queueing": 0.0, "realloc_stall": 0.0,
            "restagger": 0.0, "duration_tail": 0.0,
        }


def _as_mapping(row) -> Mapping[str, object]:
    if isinstance(row, Mapping):
        return row
    to_dict = getattr(row, "to_dict", None)  # SweepRow
    if callable(to_dict):
        return to_dict()
    raise TypeError(f"not a sweep row: {row!r}")


class SweepReducer:
    """Online reducer over sweep rows (dicts or :class:`SweepRow`\\ s).

    ``result()`` returns the same ``{policy: {n, violation_rate,
    task_miss_rate, realloc_frac, tiles_used, per_mode, [attribution]}}``
    mapping as the batch ``aggregate_sweep`` — policies and modes
    sorted, attribution present only when recorded rows were seen.
    ``result()`` does not consume the reducer; updates may continue
    afterwards.
    """

    def __init__(self) -> None:
        self._by_pol: Dict[str, _PolicyAccumulator] = {}
        self.n_rows = 0

    def update(self, row) -> None:
        r = _as_mapping(row)
        acc = self._by_pol.setdefault(str(r["policy"]), _PolicyAccumulator())
        acc.n += 1
        self.n_rows += 1
        acc.violation_sum += float(r["violation_rate"])  # type: ignore[arg-type]
        acc.miss_sum += float(r["task_miss_rate"])  # type: ignore[arg-type]
        acc.realloc_sum += float(r["realloc_frac"])  # type: ignore[arg-type]
        acc.tiles_used_max = max(acc.tiles_used_max, int(r.get("tiles_used", 0)))  # type: ignore[arg-type]
        for m, st in r["per_mode"].items():  # type: ignore[union-attr]
            b = acc.per_mode.setdefault(m, [0.0, 0, 0.0, 0, 0.0, 0])
            b[0] += float(st["violation_rate"])
            b[1] += 1
            if st["p99_s"] is not None:
                b[2] += float(st["p99_s"])
                b[3] += 1
            b[4] += float(st["realloc_frac"])
            b[5] += 1
        a = r.get("attribution")
        if a is not None:
            acc.att_n += 1
            acc.att_late += int(a["n_late"])  # type: ignore[index]
            acc.att_dropped += int(a["n_dropped"])  # type: ignore[index]
            acc.att_degraded += int(a["n_degraded"])  # type: ignore[index]
            acc.att_lateness += float(a["lateness_s"])  # type: ignore[index]
            for k in acc.att_components:
                acc.att_components[k] += float(a["components_s"][k])  # type: ignore[index]

    def update_many(self, rows: Iterable) -> "SweepReducer":
        for r in rows:
            self.update(r)
        return self

    def result(self) -> Dict[str, Dict[str, object]]:
        out: Dict[str, Dict[str, object]] = {}
        for pol, acc in sorted(self._by_pol.items()):
            n = acc.n
            out[pol] = {
                "n": n,
                "violation_rate": acc.violation_sum / n,
                "task_miss_rate": acc.miss_sum / n,
                "realloc_frac": acc.realloc_sum / n,
                "tiles_used": int(acc.tiles_used_max),
                "per_mode": {
                    m: {
                        "violation_rate": b[0] / b[1] if b[1] else float("nan"),
                        "p99_s": b[2] / b[3] if b[3] else float("nan"),
                        "realloc_frac": b[4] / b[5] if b[5] else float("nan"),
                    }
                    for m, b in sorted(acc.per_mode.items())
                },
            }
            if acc.att_n:
                out[pol]["attribution"] = {
                    "n_recorded": acc.att_n,
                    "n_late": acc.att_late,
                    "n_dropped": acc.att_dropped,
                    "n_degraded": acc.att_degraded,
                    "lateness_s": acc.att_lateness,
                    "components_s": dict(acc.att_components),
                }
        return out
