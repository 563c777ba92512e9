"""Driving modes and scenario scripts, frozen with the rest of the
reference (no runner: :mod:`h100bench.ref_soa.fan` drives the fan)."""
from .modes import MODES, DrivingMode, get_mode, mode_names, register_mode
from .script import BUNDLED_SCENARIOS, ScenarioScript, get_scenario

__all__ = [
    "MODES", "DrivingMode", "get_mode", "mode_names", "register_mode",
    "BUNDLED_SCENARIOS", "ScenarioScript", "get_scenario",
]
