"""The four assigned input-shape cells (LM-family transformers).

``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the prefill
``serve_step``; ``decode_32k`` / ``long_500k`` lower the one-token
decode ``serve_step`` with a KV/state cache of the given length.
``long_500k`` requires sub-quadratic attention and only runs for the
SSM/hybrid families (skips recorded per DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["ShapeSpec", "SHAPES", "runnable_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def runnable_cells(cfg) -> List[Tuple[str, str]]:
    """All (arch, shape) cells this config runs; long_500k only for
    sub-quadratic families."""
    cells = []
    for s in ("train_4k", "prefill_32k", "decode_32k"):
        cells.append((cfg.name, s))
    if cfg.sub_quadratic:
        cells.append((cfg.name, "long_500k"))
    return cells
