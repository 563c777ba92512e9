"""Hardware model for tile-based accelerators (paper §II-C1, §V-A).

Two instantiations ship with the framework:

* :func:`simba_chip` — the paper's evaluation platform (Simba-derived,
  128 tiles @ 2 GHz, 16 PE x 16 MAC per tile, 1.25 MB SRAM/tile, 64 B NoC
  links, LPDDR5 @ 102 GB/s).  Used by the faithful reproduction
  (Tile-stream simulator + GHA compiler + benchmarks).
* :func:`tpu_pod` — the TPU adaptation where a "tile" is one TPU v5e chip
  and the NoC is the ICI torus.  Used by the serving engine and the
  multi-pod launch path (see DESIGN.md §3).

The scheduler stack is hardware-agnostic: everything consumes a
:class:`HardwareModel`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

__all__ = [
    "HardwareModel",
    "simba_chip",
    "tpu_pod",
    "ReallocCostModel",
]


@dataclasses.dataclass(frozen=True)
class ReallocCostModel:
    """Cost of a stop-migrate-restart DoP reallocation (paper §IV-D1).

    The paper decomposes reallocation overhead into three parts (§V-A):
      1. scheduler decision  (<10 us on the RISC-V controller)
      2. context switch      (state checkpoint to DRAM)
      3. data migration      (dominant; proportional to checkpoint bytes,
                              moved over the NoC / DRAM path)

    ``latency(bytes, hops)`` returns seconds.
    """

    decision_s: float = 8e-6          # scheduler decision latency
    per_hop_s: float = 50e-9          # NoC per-hop latency
    migration_bw: float = 102e9       # bytes/s sustained for migration traffic
    fixed_s: float = 20e-6            # stop/restart control-plane constant

    def latency(self, checkpoint_bytes: float, hops: float = 4.0) -> float:
        move = checkpoint_bytes / self.migration_bw
        return self.fixed_s + self.decision_s + hops * self.per_hop_s + move


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """A tile-based accelerator (one scheduling domain).

    ``tile_flops`` is the per-tile peak (MAC counted as 2 FLOPs) so that
    per-task compute latency is ``work_flops / (c_v * tile_flops)`` —
    the ``W_v / (c_v * P)`` term of Eq. (1).
    """

    name: str
    num_tiles: int                    # M
    mesh_shape: Tuple[int, int]       # physical 2D mesh (rows, cols)
    tile_flops: float                 # peak FLOP/s per tile (P)
    tile_sram_bytes: float            # private SRAM per tile
    noc_link_bytes_per_s: float       # one NoC link
    dram_bw_bytes_per_s: float        # aggregate DRAM bandwidth
    num_memory_controllers: int
    freq_hz: float
    realloc: ReallocCostModel = dataclasses.field(default_factory=ReallocCostModel)

    def __post_init__(self) -> None:
        r, c = self.mesh_shape
        if r * c != self.num_tiles:
            raise ValueError(
                f"mesh_shape {self.mesh_shape} does not cover num_tiles={self.num_tiles}"
            )

    # -- derived ---------------------------------------------------------
    @property
    def chip_flops(self) -> float:
        return self.num_tiles * self.tile_flops

    def avg_hops_to_mc(self, partition_tiles: int) -> float:
        """Average hop count from a rectangular partition to its bound MC.

        With fixed partition->MC paths (paper §II-C1) the hop count is
        bounded by a constant ~ the partition diameter.
        """
        side = max(1.0, math.sqrt(max(partition_tiles, 1)))
        return (side - 1.0) + 1.0  # cross the partition + enter the MC node

    def realloc_latency(self, checkpoint_bytes: float, partition_tiles: int) -> float:
        return self.realloc.latency(
            checkpoint_bytes, hops=self.avg_hops_to_mc(partition_tiles)
        )

    def scaled(self, num_tiles: int) -> "HardwareModel":
        """Return a copy with a different tile count (capacities scale
        linearly with tiles, as in the paper's scaling study §V-C1)."""
        rows = int(math.sqrt(num_tiles))
        while num_tiles % rows:
            rows -= 1
        cols = num_tiles // rows
        scale = num_tiles / self.num_tiles
        return dataclasses.replace(
            self,
            num_tiles=num_tiles,
            mesh_shape=(rows, cols),
            dram_bw_bytes_per_s=self.dram_bw_bytes_per_s * scale,
            num_memory_controllers=max(1, int(round(self.num_memory_controllers * scale))),
        )


def simba_chip(num_tiles: int = 128) -> HardwareModel:
    """The paper's hardware configuration (§V-A).

    128 tiles @ 2 GHz; each tile has 16 PEs x 16 16-bit MACs
    (weight-stationary NVDLA dataflow): 16*16*2 GHz = 512 GMAC/s
    = 1.024 TFLOP/s per tile.  1.25 MB SRAM per tile; 64 B NoC links
    (@2 GHz -> 128 GB/s per link); LPDDR5 @ 102 GB/s.

    Multi-chip setups (the benchmark needs 3-5 chips = 384-640 tiles) are
    modelled as one larger mesh, as the paper does when sweeping
    tile counts {200..500}; cross-chip PCIe is folded into the I/O
    variation term F2.
    """
    freq = 2.0e9
    base = HardwareModel(
        name=f"simba-{num_tiles}t",
        num_tiles=128,
        mesh_shape=(8, 16),
        tile_flops=16 * 16 * 2 * freq,          # 1.024 TFLOP/s fp16
        tile_sram_bytes=1.25e6,
        noc_link_bytes_per_s=64 * freq,          # 128 GB/s
        dram_bw_bytes_per_s=102e9,
        num_memory_controllers=4,
        freq_hz=freq,
        realloc=ReallocCostModel(migration_bw=102e9),
    )
    if num_tiles == 128:
        return base
    return base.scaled(num_tiles)


def tpu_pod(num_chips: int = 256) -> HardwareModel:
    """TPU adaptation: one 'tile' = one v5e chip (DESIGN.md §3).

    197 bf16 TFLOP/s and 819 GB/s HBM per chip; ICI links ~50 GB/s.
    Reallocation = resharding params/KV over ICI.
    """
    rows = int(math.sqrt(num_chips))
    while num_chips % rows:
        rows -= 1
    return HardwareModel(
        name=f"tpu-v5e-{num_chips}c",
        num_tiles=num_chips,
        mesh_shape=(rows, num_chips // rows),
        tile_flops=197e12,
        tile_sram_bytes=16e9,                    # HBM plays the SRAM role
        noc_link_bytes_per_s=50e9,
        dram_bw_bytes_per_s=819e9 * num_chips,
        num_memory_controllers=num_chips,
        freq_hz=0.94e9,
        realloc=ReallocCostModel(
            decision_s=5e-6, per_hop_s=1e-6, migration_bw=50e9, fixed_s=100e-6
        ),
    )
