"""The benchmark's own operation and byte counts, worked out from shapes.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again.
"""
from __future__ import annotations

__all__ = ["alloc_ladder_bytes", "start_keep_bytes"]


def alloc_ladder_bytes(R: int, W: int, C: int, P: int, part_rows: int,
                       cand_rows: int, cap_rows: int) -> int:
    """One EDF allocation launch of ``alloc_ladder``: ``want`` (R, W) f32,
    ``entry`` (R, W) bool, ``part`` (part_rows, W) f32, ``cand_rows``
    (cand_rows, W, C) f32, ``cap_p`` (cap_rows, P) f32 and ``perm`` (W,)
    int64 read; the (R, W) f32 grants written.  ``*_rows`` is R for a
    per-lane operand and 1 for one row that every lane reads."""
    return (4 * R * W + R * W + 4 * part_rows * W + 4 * cand_rows * W * C
            + 4 * cap_rows * P + 8 * W + 4 * R * W)


def start_keep_bytes(R: int, W: int, P: int, part_rows: int, avail_rows: int) -> int:
    """One start-validation launch of the same kernel: ``d`` (R, W) f32,
    ``part`` (part_rows, W) f32, ``avail`` (avail_rows, P) f32 and
    ``perm`` (W,) int64 read; the (R, W) bool mask written."""
    return 4 * R * W + 4 * part_rows * W + 4 * avail_rows * P + 8 * W + R * W
