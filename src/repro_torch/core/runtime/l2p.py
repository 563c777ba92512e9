"""Logical-to-physical (L2P) tile mapping within a partition
(paper §IV-D3, inspired by AuRORA [30]).

Decouples a task's logical tiles from physical tiles so the runtime can
remap flexibly; on rescheduling the new placement maximises overlap
with the previous one, so only ``|c_new - c_old|`` tiles' worth of
state moves — the migration-volume model the engine charges.
"""
from __future__ import annotations

from typing import Dict, List, Set

__all__ = ["L2PMap"]


class L2PMap:
    """Physical-tile bookkeeping for one partition."""

    def __init__(self, num_tiles: int):
        self.num_tiles = num_tiles
        self.owner: List[int] = [-1] * num_tiles  # -1 = free
        self.holdings: Dict[int, Set[int]] = {}

    def free_tiles(self) -> List[int]:
        return [i for i, o in enumerate(self.owner) if o < 0]

    def allocate(self, jid: int, count: int) -> Set[int]:
        """(Re)allocate ``count`` physical tiles to job ``jid``,
        maximising overlap with its previous holding.  Returns the new
        tile set; raises if the partition lacks capacity."""
        prev = self.holdings.get(jid, set())
        keep = set(list(prev)[:count]) if len(prev) >= count else set(prev)
        need = count - len(keep)
        pool = [i for i in self.free_tiles() if i not in keep]
        if need > len(pool):
            raise ValueError(
                f"partition out of tiles: need {need}, free {len(pool)}"
            )
        new = keep | set(pool[:need])
        for t in prev - new:
            self.owner[t] = -1
        for t in new:
            self.owner[t] = jid
        if new:
            self.holdings[jid] = new
        else:
            self.holdings.pop(jid, None)
        return new

    def release(self, jid: int) -> None:
        for t in self.holdings.pop(jid, set()):
            self.owner[t] = -1

    def moved_tiles(self, jid: int, new_count: int) -> int:
        """Number of tile-states that must migrate for a resize —
        |c_new - c_old| under maximal-overlap placement."""
        prev = len(self.holdings.get(jid, set()))
        return abs(new_count - prev)
