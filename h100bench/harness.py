"""Find a cell's pieces by name and turn a run into its result line.

Nothing here knows a particular configuration, traffic mix or metric:
``BENCHMARK.json`` names them, and the files beside this one hold them.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names a run may not hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

__all__ = [
    "Check", "CellResult", "load_benchmark", "find_cell", "load_config",
    "load_traffic", "load_system", "load_reader", "cell_metrics",
    "forbidden_modules", "result_line", "check_lines",
]


@dataclasses.dataclass
class Check:
    """One number compared for ``correct``, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class CellResult:
    """What a system module hands back from one run of a cell."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    device: Dict[str, object]
    trace: Optional[object] = None          # tracing.TraceData of a --trace 1 run
    breakdown: Optional[Dict[str, list]] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.attempted > 0 and self.failed == 0 and all(
            c.ok for c in self.checks)


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict:
    return _read_json(root / "BENCHMARK.json")


def find_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in bench['workloads']]})")


def load_config(name: str, here: Path = HERE) -> Dict:
    cfg = _read_json(here / "configs" / f"{name}.json")
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def load_traffic(name: str, here: Path = HERE) -> Dict:
    mix = _read_json(here / "traffic" / f"{name}.json")
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names itself {mix.get('name')!r}")
    return mix


def load_system(name: str):
    """The module ``systems/<name>.py`` of a system: it has ``run_cell``."""
    return importlib.import_module(f"h100bench.systems.{name}")


def load_reader(metric: str, here: Path = HERE) -> Callable:
    """``read`` of ``layers/<metric>.py`` (names may hold dots, so the
    file is loaded by path)."""
    path = here / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_layer_{metric}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it under ``workloads``; a metric without the key goes to
    every cell that reports the end-to-end metric it moves (an
    end-to-end metric without it, to every cell).

    The rule by which cells come in:

    * an end-to-end metric without ``workloads`` belongs to every cell;
    * a new cell reports the end-to-end metrics the benchmark has, and
      comes in by new files and new entries alone: ``configs/<name>.json``,
      its ``configs`` entry, a ``workloads`` entry, and per-layer metrics
      of its own whose ``workloads`` name it;
    * every per-layer metric carries a ``workloads`` list;
    * a later cell that cannot report a list-free end-to-end metric gives
      that metric the list of the accepted cells that report it, in the
      change that adds the cell.
    """
    e2e = bench["end_to_end"]
    mine_e2e = {m["name"] for m in e2e if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in mine_e2e:
            out.append(m)
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of
    :data:`FORBIDDEN_MODULES`, compared whole (``repro_torch`` is not
    ``repro``)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN_MODULES)


def result_line(bench: Dict, cell: str, res: CellResult, trace: bool) -> Dict:
    """The last line of standard output, keys in the contract's order,
    the compared numbers last."""
    metrics: Dict[str, Dict[str, object]] = {}
    if trace:
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_reader(m["name"])(res.trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            if m["name"] not in res.end_to_end:
                raise KeyError(f"{cell}: the run measured no {m['name']!r}")
            metrics[m["name"]] = {"value": float(res.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    line: Dict[str, object] = {
        "correct": res.correct,
        "attempted": int(res.attempted),
        "failed": int(res.failed),
        "metrics": metrics,
        "device": res.device,
    }
    if trace and res.breakdown:
        line["breakdown"] = res.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in res.checks}
    return line


def check_lines(checks: List[Check]) -> List[str]:
    """One plain line per compared number, for the end of stderr."""
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}" for c in checks]


def device_info(count: int, memory_peak_bytes: int) -> Dict[str, object]:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": int(count),
        "memory_peak_bytes": int(memory_peak_bytes),
    }


def fan_checks(limits: Dict[str, float], readings: Dict[str, float]) -> List[Check]:
    """The readings that ``limits`` holds, in the limits' order."""
    return [Check(k, float(readings[k]), float(v)) for k, v in limits.items()]


def readings_line(readings: Dict[str, float]) -> str:
    return "readings " + json.dumps({k: readings[k] for k in sorted(readings)})
