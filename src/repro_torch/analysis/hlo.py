"""HLO-text collective accounting.

``cost_analysis()`` does not expose collective traffic, so we parse the
compiled (or lowered) HLO text: build a symbol table of instruction
result shapes per computation, then sum *operand* sizes of every
``all-gather`` / ``all-reduce`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` op.

Loop weighting: collectives inside a ``while`` body execute once per
trip, so each computation carries a multiplier derived from its
enclosing while's trip count (scan over L layers -> x L).  Without this
the collective roofline term is underestimated by the layer count.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

__all__ = ["parse_hlo_collectives", "collective_bytes"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_COMP_RE = re.compile(
    r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\(.*\))?\s*(?:->[^{]*)?\{\s*$"
)
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|[\w\[\],{}\s/#*]+?)\s+([\w\-]+)\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_ATTR_COMP_RE = re.compile(r"(to_apply|body|condition|calls)=%?([\w.\-]+)")
_CONST_INT_RE = re.compile(r"=\s*[su]\d+\[\]\s+constant\((\d+)\)")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


class _Module:
    def __init__(self, text: str):
        self.comps: Dict[str, List[str]] = {}
        self.entry: Optional[str] = None
        cur = None
        for line in text.splitlines():
            m = _COMP_RE.match(line)
            # a header is NOT an instruction ("%x = type op(...)"); the
            # param list may contain '=' inside /*index=N*/ comments
            if m and not _INSTR_RE.match(line):
                cur = m.group(1)
                self.comps[cur] = []
                if line.lstrip().startswith("ENTRY"):
                    self.entry = cur
                continue
            if line.strip() == "}":
                cur = None
                continue
            if cur is not None:
                self.comps[cur].append(line)
        if self.entry is None and self.comps:
            self.entry = next(iter(self.comps))

        # result-shape symbol table per computation (names are unique
        # module-wide in practice; keep a global table)
        self.shapes: Dict[str, str] = {}
        for lines in self.comps.values():
            for line in lines:
                im = _INSTR_RE.match(line)
                if im:
                    self.shapes[im.group(1)] = im.group(2)

    def trip_count(self, cond_comp: str) -> int:
        """Heuristic: the largest integer constant in the while condition
        computation (scan bounds lower to `compare(i, L)`)."""
        best = 1
        for line in self.comps.get(cond_comp, []):
            for c in _CONST_INT_RE.finditer(line):
                best = max(best, int(c.group(1)))
        return best

    def multipliers(self) -> Dict[str, float]:
        """Effective execution multiplier per computation."""
        mult: Dict[str, float] = {c: 0.0 for c in self.comps}

        def visit(comp: str, factor: float) -> None:
            if comp not in self.comps:
                return
            if mult[comp] >= factor:  # already visited at >= weight
                return
            mult[comp] = factor
            for line in self.comps[comp]:
                im = _INSTR_RE.match(line)
                if not im:
                    continue
                op = im.group(3)
                refs = dict(
                    (k, v) for k, v in _ATTR_COMP_RE.findall(line)
                )
                if op == "while" and "body" in refs:
                    trips = self.trip_count(refs.get("condition", ""))
                    visit(refs["body"], factor * trips)
                    if "condition" in refs:
                        visit(refs["condition"], factor * trips)
                else:
                    for k, v in refs.items():
                        visit(v, factor)
                # conditional branches
                bm = re.search(r"branch_computations=\{([^}]*)\}", line)
                if bm:
                    for b in bm.group(1).split(","):
                        visit(b.strip().lstrip("%"), factor)

        if self.entry:
            visit(self.entry, 1.0)
        return mult


def parse_hlo_collectives(hlo_text: str) -> List[Dict]:
    """Per-collective records: op kind, operand bytes, result bytes,
    instruction name, loop-weighted execution count."""
    mod = _Module(hlo_text)
    mult = mod.multipliers()

    out: List[Dict] = []
    for comp, lines in mod.comps.items():
        weight = mult.get(comp, 1.0) or 1.0
        for line in lines:
            m = _INSTR_RE.match(line)
            if not m:
                continue
            name, result_shape, op = m.group(1), m.group(2), m.group(3)
            kind = next((c for c in _COLLECTIVES if op.startswith(c)), None)
            if kind is None or op.endswith("-done"):
                continue  # -start/-done pairs: count the -start only
            try:
                args = line[line.index("(") + 1:]
            except ValueError:
                continue
            depth = 1
            body = []
            for ch in args:
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        break
                body.append(ch)
            body = "".join(body)
            op_bytes = 0
            for om in _OPERAND_RE.finditer(body):
                ref = om.group(1)
                if ref in mod.shapes:
                    op_bytes += _shape_bytes(mod.shapes[ref])
            out.append(
                {
                    "name": name,
                    "kind": kind,
                    "operand_bytes": op_bytes * weight,
                    "result_bytes": _shape_bytes(result_shape) * weight,
                    "static_operand_bytes": op_bytes,
                    "weight": weight,
                }
            )
    return out


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Aggregate loop-weighted operand bytes per collective kind."""
    recs = parse_hlo_collectives(hlo_text)
    agg: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    for r in recs:
        agg[r["kind"]] += r["operand_bytes"]
    agg["total"] = sum(agg[c] for c in _COLLECTIVES)
    agg["count"] = float(len(recs))
    return agg
