"""Largest-buffer diagnosis from compiled HLO text — the dry-run
'profiler': since there is no wall-clock trace on this container, the
§Perf loop reasons from the lowered IR (see the Pallas-specific hints
in the brief): find the biggest live values, duplicate collectives and
layout-change copies.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["top_buffers", "collective_census"]

_DB = {
    "pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}
_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^=]*?\)|[\w\[\],{}\s/#*]+?)\s+([\w\-]+)\("
)
_SHAPE = re.compile(r"(\w+)\[([\d,]*)\]")


def _nbytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DB:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DB[dt]
    return total


def top_buffers(hlo_text: str, k: int = 20, min_bytes: float = 1e8) -> List[Tuple[float, str, str]]:
    """(bytes, instr_name, op) of the k largest instruction results."""
    out = []
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        b = _nbytes(m.group(2))
        if b >= min_bytes:
            out.append((float(b), m.group(1), m.group(3)))
    out.sort(key=lambda t: -t[0])
    return out[:k]


def collective_census(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per collective kind: count + total result bytes (spotting
    redundant all-gathers of the same tensor)."""
    census: Dict[str, Dict[str, float]] = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        op = m.group(3)
        for kind in ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute"):
            if op.startswith(kind) and not op.endswith("-done"):
                c = census.setdefault(kind, {"count": 0, "bytes": 0.0})
                c["count"] += 1
                c["bytes"] += _nbytes(m.group(2))
    return census
