"""Content-addressed sweep-cell keys.

A *cell* is one (workflow, scenario, policy/replan config, seed,
backend) simulation whose summary row is immutable given the code: the
engine is deterministic, so the row is a pure function of those inputs
plus the code itself.  :func:`cell_key` hashes all of them —

* the **workflow structural signature** (what the scenario runner's
  ``build_stack`` would unroll: cockpit replicas, load factor,
  deadlines, chain/DAG structure),
* the **scenario token**: the script's structural ``cache_token()``
  (segments, bursts, dropouts, per-mode sensor-rate modulation) *and*
  its ``profile_token()`` (the registered mode transforms, which change
  sampled durations without changing structure),
* the **full policy / replan / workload config** of the spec (every
  semantic ``ScenarioSpec`` field; precompiled portfolios and
  ``mode_defs`` are excluded — they are performance vehicles whose
  content is already covered by the config and the profile token),
* the **seed**, the **backend equivalence class** ("exact" for the
  bit-identical scalar/lockstep engines, "soa_torch" for this
  package's distributional torch backend), and the **code-contract
  version**
  (:data:`CONTRACT_VERSION`) — bump it whenever an engine change
  alters row content, and every cached row is invalidated at once.

The key is a sha256 hex digest over a canonical JSON encoding, so it is
stable across processes, hosts, and Python hash randomization — the
property that lets a fleet of workers share one result cache.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Dict, Optional

from ..core.benchmark import make_ads_benchmark

__all__ = ["CONTRACT_VERSION", "cell_key", "key_payload", "resolve_backend_class"]

#: bump on any engine/summarize change that alters sweep-row content
#: for identical inputs (see docs/sweeps.md#invalidating-the-cache)
CONTRACT_VERSION = 1

#: ``ScenarioSpec`` fields that determine the row.  ``portfolio`` and
#: ``mode_defs`` are deliberately absent (see module docstring);
#: ``scenario`` and ``seed`` are handled separately.
_CONFIG_FIELDS = (
    "policy", "tiles", "cockpit_replicas", "load_factor", "deadline_s",
    "q", "num_partitions", "drop_policy", "p99_ratio", "dram_utilization",
    "replan", "replan_mode", "forecast_lead_s", "detection_delay_s",
    "route_forecast", "target_miss", "record",
)


def _canon(obj) -> object:
    """Recursively convert ``obj`` to canonical JSON-able form.

    Handles the value types that appear in scenario/mode tokens:
    scalars, tuples/lists, mappings (sorted), and frozen dataclasses
    (tagged with the class name so two types with equal fields do not
    collide).  Anything else is a hard error — silently repr()-ing
    unknown objects would bake memory addresses into cache keys.
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__dc__": type(obj).__name__,
            **{
                f.name: _canon(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, (list, tuple)):
        return [_canon(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    raise TypeError(
        f"cell_key cannot canonicalize {type(obj).__name__!r} "
        "(extend repro_torch.sweeps.cellkey._canon if this type is semantic)"
    )


@functools.lru_cache(maxsize=64)
def _workflow_signature(
    cockpit_replicas: int, load_factor: float, deadline_s: float
) -> tuple:
    """Structural signature of the workflow ``build_stack`` would
    construct for these spec fields (memoized — the benchmark DAG is
    cheap but not free, and campaigns share one workload)."""
    wf = make_ads_benchmark(
        cockpit_replicas=cockpit_replicas,
        load_factor=load_factor,
        critical_deadline_s=deadline_s,
        cockpit_deadline_s=max(deadline_s, 0.100),
    )
    return wf.structural_signature


def resolve_backend_class(backend: str) -> str:
    """Collapse a requested backend onto its cache equivalence class.

    ``scalar``/``lockstep``/``auto`` all produce bit-identical rows
    (the lockstep engine's tested contract), so their cells share
    cache entries under the class ``"exact"`` — the same class, and the
    same keys, as the JAX package's exact engines, whose rows are bit
    for bit the same.  The torch SoA backend is only distributionally
    equivalent, to the exact engines and to the JAX SoA backend alike,
    so it keeps a class of its own, ``"soa_torch"``: a shared cache
    never serves one SoA backend's row to the other.
    """
    if backend in ("auto", "scalar", "lockstep", "exact"):
        return "exact"
    if backend in ("soa", "soa_torch"):
        return "soa_torch"
    raise ValueError(f"unknown backend {backend!r}")


def key_payload(
    spec, *, backend: str = "exact",
    contract_version: Optional[int] = None,
) -> Dict[str, object]:
    """The canonical dict :func:`cell_key` hashes (exposed for tests
    and for debugging key mismatches)."""
    scen = spec.scenario
    duration = scen.duration_s if spec.duration_s is None else spec.duration_s
    return {
        "contract": CONTRACT_VERSION if contract_version is None else contract_version,
        "backend": resolve_backend_class(backend),
        "workflow": _canon(_workflow_signature(
            spec.cockpit_replicas, spec.load_factor, spec.deadline_s,
        )),
        "scenario": {
            "structure": _canon(scen.cache_token()),
            "profiles": _canon(scen.profile_token()),
        },
        "config": {f: _canon(getattr(spec, f)) for f in _CONFIG_FIELDS},
        "duration_s": float(duration),
        "seed": int(spec.seed),
    }


def cell_key(
    spec, *, backend: str = "exact",
    contract_version: Optional[int] = None,
) -> str:
    """Content-addressed key of one sweep cell (64 hex chars)."""
    payload = key_payload(
        spec, backend=backend, contract_version=contract_version,
    )
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()
