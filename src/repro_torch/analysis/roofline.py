"""Three-term roofline model from one traced step on a fake mesh.

NVIDIA H100 SXM5 80GB HBM3 constants, per GPU, from NVIDIA's H100 Tensor
Core GPU datasheet (spec-sheet values, not measurements): 989e12 dense
bf16 FLOP/s, 3.35e12 B/s HBM3, and 450e9 B/s NVLink 4 per direction
(900 GB/s total bidirectional over 18 links).

    compute    = flops            / PEAK_FLOPS
    memory     = bytes            / HBM_BW
    collective = collective_bytes / LINK_BW

``counts`` are per-device figures from :class:`~repro_torch.analysis.trace.StepCounter`
(one step traced on fake tensors under a fake process group), so the
terms are per-device time estimates directly.  Where the reference reads
a compiled XLA module (``roofline_from_compiled``: loop-weighted HLO
flops, fusion-boundary bytes, collective operand bytes), the port reads
the eager op stream: FlopCounterMode's formulas, every op's operand and
result bytes, and every ``_c10d_functional`` collective's operand bytes.
Eager torch has no fusion, so the bytes term counts every op's traffic:
it is larger than XLA's fusion-boundary count, and is not scaled.
MODEL_FLOPS uses the 6*N*D (train) / 2*N*D (inference forward)
convention with N_active for MoE.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["HW", "HWConstants", "RooflineTerms", "model_flops", "roofline_from_trace"]


@dataclasses.dataclass(frozen=True)
class HWConstants:
    name: str = "NVIDIA H100 SXM5 80GB HBM3 (datasheet)"
    peak_flops: float = 989e12       # dense bf16 FLOP/s per GPU
    hbm_bw: float = 3.35e12          # bytes/s per GPU
    link_bw: float = 450e9           # NVLink 4, bytes/s per GPU per direction


HW = HWConstants()


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw per-device quantities from the traced step
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    # the three terms (seconds)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    # usefulness
    model_flops_global: float = 0.0
    tokens: int = 0
    raw_cost_analysis: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.compute_s = self.flops_per_device / HW.peak_flops
        self.memory_s = self.bytes_per_device / HW.hbm_bw
        self.collective_s = self.collective_bytes_per_device / HW.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs (global) — remat/redundancy waste."""
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chips' peak the *useful* model FLOPs achieve
        if execution takes exactly the dominant term."""
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops_global / (self.chips * HW.peak_flops)
        return ideal / self.bound_s

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "tokens": self.tokens,
            "raw_cost_analysis": self.raw_cost_analysis,
            "bound_s": self.bound_s,
        }


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D per inference forward; N_active
    for MoE."""
    n = cfg.active_param_count() if cfg.num_experts else cfg.param_count()
    per_tok = 6.0 if shape_kind == "train" else 2.0
    return per_tok * n * tokens


def roofline_from_trace(
    arch: str,
    shape,
    mesh_name: str,
    chips: int,
    counts: Dict,
    cfg,
) -> RooflineTerms:
    """The roofline of one traced step: ``counts`` holds per-device
    ``flops``, ``bytes``, ``collective`` (bytes by kind, with ``total`` and
    ``count``) and ``ops`` (:meth:`StepCounter.counts`)."""
    coll = counts["collective"]
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    terms = RooflineTerms(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["bytes"]),
        collective_bytes_per_device=float(coll["total"]),
        collective_breakdown={
            k: v for k, v in coll.items() if k not in ("total", "count")
        },
        model_flops_global=model_flops(cfg, shape.kind, tokens),
        tokens=tokens,
    )
    terms.raw_cost_analysis = {"ops": float(counts.get("ops", 0)),
                               "collectives": float(coll.get("count", 0))}
    return terms
