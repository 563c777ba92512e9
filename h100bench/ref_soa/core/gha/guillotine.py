"""Physical partition binding via Guillotine cutting (paper §III-B5).

Maps logical bin capacities to rectangular tile regions of the physical
2D mesh through a series of bisecting end-to-end cuts [Beasley 1985],
then binds each rectangle to its nearest boundary memory controller —
minimizing cross-partition NoC traffic and fixing data paths.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from ..hardware import HardwareModel

__all__ = ["guillotine_cut", "bind_memory_controllers", "mc_positions"]

Rect = Tuple[int, int, int, int]  # (row0, col0, height, width)


def guillotine_cut(
    mesh_shape: Tuple[int, int], areas: Sequence[int]
) -> List[Rect]:
    """Cut the (rows x cols) mesh into len(areas) rectangles whose sizes
    are proportional to ``areas`` (each >= its requested area when the
    mesh has spare tiles; total area == rows*cols).

    Recursive bisection: split the bin set into two groups of nearly
    equal total area, cut the rectangle along its longer edge at the
    proportional integer boundary, recurse.
    """
    rows, cols = mesh_shape
    total_tiles = rows * cols
    need = sum(areas)
    if need > total_tiles:
        raise ValueError(f"areas sum {need} exceeds mesh {total_tiles}")
    if not areas:
        return []

    result: List[Rect] = [None] * len(areas)  # type: ignore[list-item]

    def split_ok(span: int, other: int, need1: int, need2: int):
        """Integer cut position along ``span`` such that both sides hold
        their needs; None if impossible on this axis."""
        lo = -(-need1 // other)                 # ceil(need1 / other)
        hi = span - (-(-need2 // other))
        if lo == 0:
            lo = 1
        if lo <= hi and 0 < lo < span:
            # bias toward proportional position within the feasible band
            prop = round(span * need1 / max(need1 + need2, 1))
            return min(max(prop, lo), hi)
        return None

    def cut(rect: Rect, idxs: List[int]) -> bool:
        r0, c0, h, w = rect
        if len(idxs) == 1:
            if h * w < areas[idxs[0]]:
                return False
            result[idxs[0]] = rect
            return True
        # balanced two-way split of the bin set by area (greedy LPT)
        idxs_sorted = sorted(idxs, key=lambda i: -areas[i])
        groupings = []
        g1: List[int] = []
        g2: List[int] = []
        a1 = a2 = 0
        for i in idxs_sorted:
            if a1 <= a2:
                g1.append(i)
                a1 += areas[i]
            else:
                g2.append(i)
                a2 += areas[i]
        groupings.append((g1, g2, a1, a2))
        # alternatives: every prefix split of the size-sorted list
        # (covers e.g. [9,2] | [1,1,1] where LPT pairs 9 with the ones)
        for i in range(1, len(idxs_sorted)):
            ga = idxs_sorted[:i]
            gb = idxs_sorted[i:]
            groupings.append((
                ga, gb,
                sum(areas[j] for j in ga), sum(areas[j] for j in gb),
            ))

        for ga, gb, na, nb in groupings:
            # try the longer axis first, then the other
            axes = ("w", "h") if w >= h else ("h", "w")
            for ax in axes:
                if ax == "w":
                    pos = split_ok(w, h, na, nb)
                    if pos is None:
                        continue
                    if cut((r0, c0, h, pos), ga) and cut(
                        (r0, c0 + pos, h, w - pos), gb
                    ):
                        return True
                else:
                    pos = split_ok(h, w, na, nb)
                    if pos is None:
                        continue
                    if cut((r0, c0, pos, w), ga) and cut(
                        (r0 + pos, c0, h - pos, w), gb
                    ):
                        return True
        return False

    if not cut((0, 0, rows, cols), list(range(len(areas)))):
        raise ValueError(
            f"guillotine cutting failed for areas {list(areas)} on "
            f"{mesh_shape} (fragmentation)"
        )
    return result


def mc_positions(hw: HardwareModel) -> List[Tuple[float, float]]:
    """Memory controllers sit at the mesh boundary (paper §II-C1): spread
    evenly along the perimeter midpoints."""
    rows, cols = hw.mesh_shape
    n = hw.num_memory_controllers
    anchors = [
        (0.0, cols / 2),          # top edge
        (rows - 1.0, cols / 2),   # bottom edge
        (rows / 2, 0.0),          # left edge
        (rows / 2, cols - 1.0),   # right edge
    ]
    return [anchors[i % 4] for i in range(n)]


def bind_memory_controllers(
    rects: Sequence[Rect], hw: HardwareModel
) -> List[int]:
    """Nearest-MC binding by Manhattan distance from the rect centre."""
    mcs = mc_positions(hw)
    out: List[int] = []
    for r0, c0, h, w in rects:
        cy, cx = r0 + h / 2, c0 + w / 2
        best = min(
            range(len(mcs)),
            key=lambda i: abs(mcs[i][0] - cy) + abs(mcs[i][1] - cx),
        )
        out.append(best)
    return out
