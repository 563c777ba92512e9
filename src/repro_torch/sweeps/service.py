"""Work-sharded sweep campaigns: build cells, serve from cache, execute
the rest, aggregate online, record a resumable manifest.

A **campaign** is the declarative form of ``repro_torch.scenarios.sweep``:
``n_scenarios`` Markov-sampled drives x ``policies``, with the same
deterministic seeding (scenario ``i`` uses ``seed * 100003 + i``), the
same per-policy portfolio sharing, and the same backend semantics — so
a campaign executed cold produces row-for-row the list ``sweep()``
returns.  What the campaign adds is durability and scale:

* every cell is **content-addressed** (:mod:`repro_torch.sweeps.cellkey`);
  rows land in an on-disk :class:`~repro_torch.sweeps.cache.ResultCache`,
  so re-running an identical campaign executes zero cells and
  extending one (more seeds, one more policy) executes only the new
  cells;
* a **manifest** (:mod:`repro_torch.sweeps.manifest`) records the campaign
  spec and per-cell status — the resume format ``benchmarks/run.py
  --campaign`` and the weekly extended-sweep CI job consume;
* execution is **pluggable** (:mod:`repro_torch.sweeps.executor`): the local
  spawn pool, or manifest shards across worker subprocesses/hosts;
* aggregation **streams** (:class:`~repro_torch.sweeps.reduce.SweepReducer`)
  so a 100k-drive campaign never needs all rows in memory
  (``keep_rows=False``);
* a crashing cell no longer destroys the sweep: per-cell errors are
  captured, every finished row is persisted to the cache *before* the
  failure re-raises, and the failed cell keys are surfaced in the
  manifest (:class:`SweepFailure`).
"""
from __future__ import annotations

import dataclasses
import traceback
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .._device import resolve_device
from .cache import ResultCache
from .cellkey import cell_key, resolve_backend_class
from .executor import ItemFailure, LocalPoolExecutor, SubprocessShardExecutor
from .manifest import CampaignManifest, CellRecord
from .reduce import SweepReducer

__all__ = [
    "CampaignSpec",
    "Cell",
    "CampaignResult",
    "SweepFailure",
    "build_cells",
    "run_campaign",
]


# ---------------------------------------------------------------------------
# campaign spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CampaignSpec:
    """Declarative description of one sweep campaign (JSON-able, so a
    manifest can rebuild every cell deterministically)."""

    name: str = "campaign"
    n_scenarios: int = 4
    policies: Tuple[str, ...] = ("ads_tile", "tp_driven")
    #: per-drive scenario length fed to the Markov generator
    scenario_duration_s: float = 2.0
    seed: int = 0
    replan: bool = True
    #: requested engine: "auto"/"scalar"/"lockstep" (bit-identical rows,
    #: cache class "exact") or "soa" (distributional, own cache class
    #: "soa_torch")
    backend: str = "auto"
    #: None = the bundled default generator
    generator: Optional[object] = None          # MarkovScenarioGenerator
    #: extra ScenarioSpec fields (tiles, record, target_miss, ...)
    spec_kw: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: mode definitions to register before building cells; None = the
    #: registry's current modes for the generator's mode set.  Filled
    #: on serialization so shard workers in fresh processes see custom
    #: modes.
    mode_defs: Optional[Dict[str, object]] = None

    def __post_init__(self) -> None:
        self.policies = tuple(self.policies)
        if self.n_scenarios < 1:
            raise ValueError("n_scenarios must be >= 1")
        if not self.policies:
            raise ValueError("campaign needs at least one policy")

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, object]:
        from ..scenarios.modes import get_mode
        from ..scenarios.script import default_generator

        gen = self.generator or default_generator()
        mode_defs = self.mode_defs or {
            m: get_mode(m) for m in sorted(gen.transitions)
        }
        return {
            "name": self.name,
            "n_scenarios": self.n_scenarios,
            "policies": list(self.policies),
            "scenario_duration_s": self.scenario_duration_s,
            "seed": self.seed,
            "replan": self.replan,
            "backend": self.backend,
            "generator": (
                None if self.generator is None
                else dataclasses.asdict(self.generator)
            ),
            "spec_kw": dict(self.spec_kw),
            "modes": {
                m: dataclasses.asdict(d) for m, d in sorted(mode_defs.items())
            },
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "CampaignSpec":
        from ..scenarios.modes import DrivingMode
        from ..scenarios.script import MarkovScenarioGenerator

        gen = None
        g = d.get("generator")
        if g is not None:
            g = dict(g)  # type: ignore[arg-type]
            g["dropout_sensors"] = tuple(g.get("dropout_sensors", ()))
            gen = MarkovScenarioGenerator(**g)
        mode_defs = None
        if d.get("modes"):
            mode_defs = {
                m: DrivingMode(**md)  # type: ignore[arg-type]
                for m, md in d["modes"].items()  # type: ignore[union-attr]
            }
        return cls(
            name=str(d.get("name", "campaign")),
            n_scenarios=int(d["n_scenarios"]),  # type: ignore[arg-type]
            policies=tuple(d.get("policies", ("ads_tile", "tp_driven"))),  # type: ignore[arg-type]
            scenario_duration_s=float(d.get("scenario_duration_s", 2.0)),  # type: ignore[arg-type]
            seed=int(d.get("seed", 0)),  # type: ignore[arg-type]
            replan=bool(d.get("replan", True)),
            backend=str(d.get("backend", "auto")),
            generator=gen,
            spec_kw=dict(d.get("spec_kw", {})),  # type: ignore[arg-type]
            mode_defs=mode_defs,
        )


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """One (scenario, policy, seed) unit of campaign work."""

    index: int
    scenario_index: int
    spec: object               # ScenarioSpec
    key: str
    backend_class: str         # "exact" | "soa_torch"


def build_cells(campaign: CampaignSpec) -> List[Cell]:
    """Deterministically expand a campaign into its cells.

    Mirrors ``repro_torch.scenarios.sweep`` exactly: scenario ``i`` is
    sampled with seed ``campaign.seed * 100003 + i`` and simulated with
    that seed for every policy, so policy comparisons stay paired.
    """
    from ..scenarios import runner as _runner
    from ..scenarios.modes import get_mode, register_mode
    from ..scenarios.script import default_generator

    gen = campaign.generator or default_generator()
    all_modes = sorted(gen.transitions)
    if campaign.mode_defs:
        # a campaign deserialized in a fresh process carries its mode
        # definitions along (idempotent re-registration, like
        # ScenarioSpec.mode_defs in pool workers)
        for mode in campaign.mode_defs.values():
            register_mode(mode, overwrite=True)
    mode_defs = {m: get_mode(m) for m in all_modes}

    cells: List[Cell] = []
    for i in range(campaign.n_scenarios):
        s_i = campaign.seed * 100003 + i
        script = gen.sample(campaign.scenario_duration_s, seed=s_i)
        for pol in campaign.policies:
            spec = _runner.ScenarioSpec(
                scenario=script, policy=pol, replan=campaign.replan,
                seed=s_i, mode_defs=mode_defs, **campaign.spec_kw,
            )
            bclass = _cell_backend_class(campaign.backend, spec)
            cells.append(Cell(
                index=len(cells), scenario_index=i, spec=spec,
                key=cell_key(spec, backend=bclass), backend_class=bclass,
            ))
    return cells


def _cell_backend_class(requested: str, spec) -> str:
    """The cache equivalence class a cell will actually run under —
    the single place the per-spec SoA fallback decision is made for
    campaigns (the runner's ``run()`` owns it for direct calls)."""
    if requested == "soa":
        from ..scenarios.runner import soa_usable

        ok, _why = soa_usable(spec)
        return resolve_backend_class("soa") if ok else "exact"
    return resolve_backend_class(requested)


def _attach_portfolios(cells: Sequence[Cell], campaign: CampaignSpec) -> None:
    """One schedule portfolio per policy, shared by every cell of that
    policy (the ``sweep()`` optimization: compile once in the parent
    instead of once per worker run)."""
    from ..scenarios.runner import compile_portfolio
    from ..scenarios.script import default_generator

    gen = campaign.generator or default_generator()
    all_modes = sorted(gen.transitions)
    portfolios: Dict[str, object] = {}
    for cell in cells:
        pol = cell.spec.policy
        if pol not in portfolios:
            portfolios[pol] = compile_portfolio(cell.spec, all_modes)
        cell.spec = dataclasses.replace(cell.spec, portfolio=portfolios[pol])


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _GroupTask:
    """One executor work item: every pending cell of one scenario
    (paired policies share the scenario's sampled trace)."""

    specs: List[object]
    cells: List[Tuple[int, str]]       # (cell index, cell key)
    backend: str                       # campaign's requested backend
    #: where the SoA backend runs (``"cuda"`` / ``"cpu"``); not part of
    #: a cell key — the exact engines run on the host whatever it is
    device: str = "cuda"


def _run_cell_group(task: _GroupTask) -> List[tuple]:
    """Run one scenario's pending cells; per-cell error capture.

    Returns ``("ok", index, key, row)`` / ``("err", index, key, error)``
    tuples.  A group-level failure (e.g. trace sampling) retries each
    spec alone so one broken cell cannot take its siblings' results
    down with it.
    """
    from ..scenarios import runner as _runner

    backend = "lockstep" if task.backend == "auto" else task.backend
    try:
        rows = _runner._run_group(
            task.specs, backend=backend, device=task.device,
        )
        return [
            ("ok", idx, key, row)
            for (idx, key), row in zip(task.cells, rows)
        ]
    except Exception:
        out: List[tuple] = []
        for (idx, key), spec in zip(task.cells, task.specs):
            try:
                row = _runner._run_group(
                    [spec], backend=backend, device=task.device,
                )[0]
                out.append(("ok", idx, key, row))
            except Exception as exc:  # noqa: BLE001 - captured per cell
                out.append((
                    "err", idx, key,
                    f"{exc!r}\n{traceback.format_exc()}",
                ))
        return out


class SweepFailure(RuntimeError):
    """Raised when cells failed and ``allow_failures`` is off.  By the
    time this surfaces, every *finished* cell's row is already
    persisted in the cache and the manifest lists the failed keys —
    rerunning the same campaign retries only the failures."""

    def __init__(self, failed_keys: Sequence[str], result: "CampaignResult",
                 detail: str = "") -> None:
        self.failed_keys = list(failed_keys)
        self.result = result
        msg = (
            f"{len(self.failed_keys)} sweep cell(s) failed "
            f"(completed rows are cached; failed keys in the manifest)"
        )
        if detail:
            msg += f": {detail.splitlines()[0]}"
        super().__init__(msg)


@dataclasses.dataclass
class CampaignResult:
    """Outcome of :func:`run_campaign`."""

    campaign: CampaignSpec
    manifest: CampaignManifest
    #: successful rows in cell order (``None`` when ``keep_rows=False``)
    rows: Optional[List[Dict[str, object]]]
    #: streaming per-policy aggregate (:meth:`SweepReducer.result`)
    aggregate: Dict[str, Dict[str, object]]
    n_cells: int
    n_cached: int
    n_executed: int
    n_failed: int
    failed_keys: List[str]


def _coerce_campaign(
    campaign: Union[CampaignSpec, Mapping, str, Path],
) -> Tuple[CampaignSpec, Optional[str]]:
    """Accept a spec object, a spec dict, a campaign-spec JSON path, or
    a manifest JSON path; return ``(spec, manifest_cache_dir)``."""
    if isinstance(campaign, CampaignSpec):
        return campaign, None
    if isinstance(campaign, (str, Path)):
        import json

        with open(campaign, "r", encoding="utf-8") as fh:
            campaign = json.load(fh)
    if not isinstance(campaign, Mapping):
        raise TypeError(f"not a campaign: {campaign!r}")
    if CampaignManifest.is_manifest(dict(campaign)):
        return (
            CampaignSpec.from_dict(campaign["campaign"]),  # type: ignore[index]
            campaign.get("cache_dir"),  # type: ignore[union-attr]
        )
    return CampaignSpec.from_dict(campaign), None


def run_campaign(
    campaign: Union[CampaignSpec, Mapping, str, Path],
    *,
    cache_dir: Union[str, Path, None] = None,
    manifest_path: Union[str, Path, None] = None,
    executor: Union[LocalPoolExecutor, SubprocessShardExecutor, None] = None,
    jobs: Optional[int] = None,
    reducer: Optional[SweepReducer] = None,
    keep_rows: bool = True,
    allow_failures: bool = False,
    device="cuda",
) -> CampaignResult:
    """Run (or resume) a campaign against a content-addressed cache.

    ``campaign`` may be a :class:`CampaignSpec`, a campaign-spec dict /
    JSON path, or a previously saved **manifest** path — resumption is
    simply re-running: cells whose rows are in the cache are served
    without executing, the rest run, and the resumed result is
    row-for-row identical to an uninterrupted run (cells are
    deterministic and content-addressed).

    ``executor`` defaults to :class:`LocalPoolExecutor(jobs)`; pass a
    :class:`SubprocessShardExecutor` to fan the manifest out across
    worker invocations (requires ``manifest_path``).  ``keep_rows=False``
    streams every row straight into the reducer and returns
    ``rows=None`` — the O(1)-memory shape for very large campaigns.

    ``device`` (default ``"cuda"``, resolved first: without a card the
    call raises unless it is ``"cpu"``) is where SoA cells run; it
    travels to every worker and shard and is not part of a cell key.
    """
    device = str(resolve_device(device))
    spec_obj, manifest_cache = _coerce_campaign(campaign)
    if cache_dir is None:
        cache_dir = manifest_cache
    if cache_dir is None:
        raise ValueError(
            "cache_dir is required (or resume from a manifest that "
            "records one)"
        )
    cache = ResultCache(cache_dir)
    reducer = reducer if reducer is not None else SweepReducer()

    cells = build_cells(spec_obj)
    records = [
        CellRecord(
            index=c.index, key=c.key, scenario_index=c.scenario_index,
            policy=str(c.spec.policy), seed=int(c.spec.seed),
            backend=c.backend_class,
        )
        for c in cells
    ]
    manifest = CampaignManifest(
        campaign=spec_obj.to_dict(), cells=records,
        cache_dir=str(cache.root),
    )

    rows: List[Optional[Dict[str, object]]] = [None] * len(cells)
    n_cached = 0
    for c, recd in zip(cells, records):
        row = cache.get(c.key)
        if row is not None:
            n_cached += 1
            recd.mark("cached", cache_path=cache.relative_path(c.key))
            if keep_rows:
                rows[c.index] = row
            else:
                reducer.update(row)
    if manifest_path is not None:
        manifest.save(manifest_path)

    missing = [c for c in cells if records[c.index].status == "pending"]
    n_executed = 0
    if missing:
        if isinstance(executor, SubprocessShardExecutor):
            if manifest_path is None:
                raise ValueError(
                    "SubprocessShardExecutor needs manifest_path (the "
                    "manifest is the work-distribution medium)"
                )
            n_executed = _execute_sharded(
                executor, manifest, manifest_path, cache, missing,
                records, rows, reducer, keep_rows, device,
            )
        else:
            n_executed = _execute_local(
                executor or LocalPoolExecutor(jobs), spec_obj, cache,
                missing, records, rows, reducer, keep_rows,
                manifest, manifest_path, device,
            )
    if keep_rows:
        for row in rows:
            if row is not None:
                reducer.update(row)

    if manifest_path is not None:
        manifest.save(manifest_path)
    failed = manifest.failed_keys()
    result = CampaignResult(
        campaign=spec_obj,
        manifest=manifest,
        rows=(
            [r for r in rows if r is not None] if keep_rows else None
        ),
        aggregate=reducer.result(),
        n_cells=len(cells),
        n_cached=n_cached,
        n_executed=n_executed,
        n_failed=len(failed),
        failed_keys=failed,
    )
    if failed and not allow_failures:
        first = next(
            (r.error for r in records if r.status == "failed" and r.error),
            "",
        )
        raise SweepFailure(failed, result, detail=first or "")
    return result


def _execute_local(
    executor: LocalPoolExecutor,
    spec_obj: CampaignSpec,
    cache: ResultCache,
    missing: Sequence[Cell],
    records: Sequence[CellRecord],
    rows: List[Optional[Dict[str, object]]],
    reducer: SweepReducer,
    keep_rows: bool,
    manifest: CampaignManifest,
    manifest_path,
    device: str,
) -> int:
    _attach_portfolios(missing, spec_obj)
    groups: Dict[int, List[Cell]] = {}
    for c in missing:
        groups.setdefault(c.scenario_index, []).append(c)
    tasks = [
        _GroupTask(
            specs=[c.spec for c in cs],
            cells=[(c.index, c.key) for c in cs],
            backend=spec_obj.backend,
            device=device,
        )
        for _si, cs in sorted(groups.items())
    ]
    n_executed = 0
    for i, outcome in executor.imap(_run_cell_group, tasks):
        task = tasks[i]
        if isinstance(outcome, ItemFailure):
            for idx, _key in task.cells:
                records[idx].mark("failed", error=(
                    f"{outcome.error}\n{outcome.traceback}"
                ))
        else:
            for entry in outcome:
                if entry[0] == "ok":
                    _tag, idx, key, row = entry
                    cache.put(key, row)
                    records[idx].mark(
                        "done", cache_path=cache.relative_path(key),
                    )
                    n_executed += 1
                    if keep_rows:
                        rows[idx] = row
                    else:
                        reducer.update(row)
                else:
                    _tag, idx, _key, err = entry
                    records[idx].mark("failed", error=err)
        if manifest_path is not None:
            # checkpoint after every group: an interruption here loses
            # at most the in-flight groups, never finished cells
            manifest.save(manifest_path)
    return n_executed


def _execute_sharded(
    executor: SubprocessShardExecutor,
    manifest: CampaignManifest,
    manifest_path,
    cache: ResultCache,
    missing: Sequence[Cell],
    records: Sequence[CellRecord],
    rows: List[Optional[Dict[str, object]]],
    reducer: SweepReducer,
    keep_rows: bool,
    device: str,
) -> int:
    shard_results = executor.run_manifest(
        manifest_path, cache.root, device=device,
    )
    reported: Dict[str, Optional[str]] = {}
    for sr in shard_results:
        for cd in sr.cells:
            reported[str(cd["key"])] = cd.get("error")
    n_executed = 0
    for c in missing:
        row = cache.get(c.key)
        if row is not None:
            n_executed += 1
            records[c.index].mark(
                "done", cache_path=cache.relative_path(c.key),
            )
            if keep_rows:
                rows[c.index] = row
            else:
                reducer.update(row)
        else:
            err = reported.get(c.key) or (
                "cell not executed by any shard (worker crash? see "
                "shard stderr)"
            )
            records[c.index].mark("failed", error=err)
    return n_executed
