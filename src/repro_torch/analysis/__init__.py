"""Analysis: HLO-text collective, cost and buffer accounting (the
reference's parsers, verbatim: they read HLO text, which the reference
produces), the per-device counts of a traced step, and the three-term
roofline model on H100 constants."""
from .hlo import collective_bytes, parse_hlo_collectives
from .roofline import HW, RooflineTerms, roofline_from_trace

__all__ = [
    "collective_bytes",
    "parse_hlo_collectives",
    "RooflineTerms",
    "roofline_from_trace",
    "HW",
]
