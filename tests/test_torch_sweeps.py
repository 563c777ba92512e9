"""The port's sweep service — cell keys, result cache, manifests,
executors, the campaign service and the runner's sweep half — against
the JAX reference, run live in the same process on the CPU.

* exact-class cell keys equal the reference's for the same spec (a
  shared cache serves bit-identical rows to either package); the
  port's SoA class (``"soa_torch"``) differs from every other class;
* ``sweep(..., backend="lockstep", device="cpu")`` rows and
  ``aggregate_sweep`` equal the reference's;
* campaigns: a repeat is all cache hits, an interrupted campaign
  resumes row for row, failures are captured per cell, and a
  ``SubprocessShardExecutor`` shard runs through
  ``python -m repro_torch.sweeps.worker --device cpu``;
* ``parallel_map`` keeps the reference's error semantics.
"""
import dataclasses
import json

import pytest
import torch

import repro.sweeps as sweeps_ref
from repro.scenarios import runner as runner_ref
from repro.scenarios.script import default_generator as default_generator_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.modes import get_mode
from repro_torch.scenarios.script import default_generator
from repro_torch.scenarios.script import get_scenario as get_scenario_t
from repro_torch.sweeps import (
    CONTRACT_VERSION,
    CampaignSpec,
    ItemFailure,
    ResultCache,
    SubprocessShardExecutor,
    SweepFailure,
    SweepReducer,
    SweepRow,
    build_cells,
    cell_key,
    key_payload,
    resolve_backend_class,
    run_campaign,
)
from repro_torch.sweeps.manifest import CampaignManifest, CellRecord
from repro_torch.sweeps.worker import main as worker_main
from repro_torch.sweeps.worker import run_shard

torch.set_num_threads(1)

CPU = "cpu"

CAMPAIGN_KW = dict(
    name="t", n_scenarios=2, policies=("ads_tile", "tp_driven"),
    scenario_duration_s=0.4, seed=5,
)


def _pair(scenario="calm_to_rush", policy="ads_tile", seed=3, **kw):
    a = runner_ref.ScenarioSpec(scenario=get_scenario_ref(scenario), policy=policy, seed=seed, **kw)
    b = runner_t.ScenarioSpec(scenario=get_scenario_t(scenario), policy=policy, seed=seed, **kw)
    return a, b


def _campaign_ref(**kw):
    return sweeps_ref.CampaignSpec(**{**CAMPAIGN_KW, **kw})


def _campaign_t(**kw):
    return CampaignSpec(**{**CAMPAIGN_KW, **kw})


def _manifest(spec, cache, path):
    cells = build_cells(spec)
    CampaignManifest(
        campaign=spec.to_dict(),
        cells=[
            CellRecord(index=c.index, key=c.key, scenario_index=c.scenario_index,
                       policy=str(c.spec.policy), seed=int(c.spec.seed),
                       backend=c.backend_class)
            for c in cells
        ],
        cache_dir=str(cache),
    ).save(path)


# ---------------------------------------------------------------------------
# cell keys
# ---------------------------------------------------------------------------
KEY_CASES = [
    {},
    {"seed": 99},
    {"policy": "tp_driven"},
    {"replan": False},
    {"replan_mode": "predictive"},
    {"target_miss": 0.05},
    {"tiles": 256},
    {"load_factor": 1.2},
    {"drop_policy": "hard"},
    {"duration_s": 0.9},
    {"record": True},
    {"scenario": "commute"},
    {"scenario": "degraded_commute"},
]


def _specs_with(change):
    change = dict(change)
    scen = change.pop("scenario", "calm_to_rush")
    return _pair(scen, **{"policy": "ads_tile", "seed": 3, **change})


@pytest.mark.parametrize("change", KEY_CASES, ids=lambda c: "-".join(map(str, c.items())) or "base")
def test_exact_cell_keys_equal_reference(change):
    a, b = _specs_with(change)
    for backend in ("auto", "scalar", "lockstep"):
        assert cell_key(b, backend=backend) == sweeps_ref.cell_key(a, backend=backend)
    assert sweeps_ref.key_payload(a) == json.loads(json.dumps(key_payload(b)))
    if change:
        assert cell_key(b) != cell_key(_specs_with({})[1])


def test_soa_class_is_the_ports_own():
    a, b = _pair()
    assert resolve_backend_class("soa") == "soa_torch"
    assert resolve_backend_class("soa_torch") == "soa_torch"
    exact = cell_key(b)
    soa_port = cell_key(b, backend="soa")
    soa_ref = sweeps_ref.cell_key(a, backend="soa")
    assert len({exact, soa_port, soa_ref}) == 3
    with pytest.raises(ValueError):
        cell_key(b, backend="warp")


def test_cell_key_stable_under_derived_fields_and_moves_with_contract(monkeypatch):
    _a, b = _pair()
    base = cell_key(b)
    derived = dataclasses.replace(
        b, portfolio=runner_t.compile_portfolio(b),
        mode_defs={m: get_mode(m) for m in b.scenario.modes()},
    )
    assert cell_key(derived) == base
    from repro_torch.sweeps import cellkey as ck

    monkeypatch.setattr(ck, "CONTRACT_VERSION", CONTRACT_VERSION + 1)
    assert cell_key(b) != base


def test_campaign_cells_use_the_soa_torch_class():
    cells = build_cells(_campaign_t(backend="soa"))
    assert {c.backend_class for c in cells} == {"soa_torch"}
    exact = build_cells(_campaign_t())
    ref = sweeps_ref.build_cells(_campaign_ref())
    assert [c.key for c in exact] == [c.key for c in ref]
    assert not {c.key for c in cells} & {c.key for c in exact}


# ---------------------------------------------------------------------------
# sweeps and aggregation against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sweep_rows():
    rows_a = runner_ref.sweep(3, backend="lockstep", jobs=1)
    rows_b = runner_t.sweep(3, backend="lockstep", jobs=1, device=CPU)
    return rows_a, rows_b


def test_lockstep_sweep_rows_equal_reference(sweep_rows):
    rows_a, rows_b = sweep_rows
    assert len(rows_b) == 6
    assert rows_a == rows_b


def test_aggregate_sweep_equals_reference(sweep_rows):
    rows_a, rows_b = sweep_rows
    agg = runner_t.aggregate_sweep(rows_b)
    assert agg == runner_ref.aggregate_sweep(rows_a)
    red = SweepReducer()
    for row in rows_b:
        red.update(row)
    assert red.result() == agg


def test_sweep_row_round_trip(sweep_rows):
    _a, b = _pair()
    [r] = runner_t.run(b, device=CPU)
    row = SweepRow.from_report(b, r)
    assert row.to_dict() == runner_t.summarize(b, r)
    for swept in sweep_rows[1]:
        assert SweepRow.from_dict(swept).to_dict() == swept


def test_scalar_sweep_and_pool_sweep_equal_lockstep(sweep_rows):
    kw = dict(policies=("ads_tile", "cyc"), duration_s=0.4, seed=2, device=CPU)
    lock = runner_t.sweep(2, backend="lockstep", jobs=1, **kw)
    assert runner_t.sweep(2, backend="scalar", jobs=1, **kw) == lock
    # two spawned workers: the device travels with each group
    assert runner_t.sweep(2, backend="lockstep", jobs=2, **kw) == lock
    assert runner_ref.sweep(2, policies=("ads_tile", "cyc"), duration_s=0.4, seed=2, jobs=1) == lock


def test_sweep_resolves_device_first(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner_t.sweep(1, jobs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner_t._run_group([_pair()[1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(_campaign_t(), cache_dir="unused")


def test_run_validations():
    _a, b = _pair()
    with pytest.raises(ValueError, match="seeds"):
        runner_t.run([b, b], seeds=[0, 1], device=CPU)
    with pytest.raises(ValueError, match="trace"):
        runner_t.run(b, seeds=[0, 1], trace=object(), device=CPU)
    with pytest.raises(ValueError, match="backend"):
        runner_t.run(b, backend="warp", device=CPU)
    with pytest.raises(ValueError, match="options"):
        runner_t.run(b, options=object(), device=CPU)


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------
def test_campaign_repeat_is_all_cache_hits(tmp_path):
    cache = tmp_path / "cache"
    first = run_campaign(_campaign_t(), cache_dir=cache, jobs=1, device=CPU)
    assert (first.n_cells, first.n_executed, first.n_cached) == (4, 4, 0)
    again = run_campaign(_campaign_t(), cache_dir=cache, jobs=1, device=CPU)
    assert (again.n_executed, again.n_cached) == (0, 4)
    assert again.rows == first.rows
    assert again.aggregate == first.aggregate
    ref = sweeps_ref.run_campaign(_campaign_ref(), cache_dir=tmp_path / "ref", jobs=1)
    assert ref.rows == first.rows
    assert ref.aggregate == first.aggregate
    # a cache the reference filled serves the port's exact cells
    shared = run_campaign(_campaign_t(), cache_dir=tmp_path / "ref", jobs=1, device=CPU)
    assert (shared.n_executed, shared.n_cached) == (0, 4)
    direct = runner_t.sweep(
        CAMPAIGN_KW["n_scenarios"], policies=CAMPAIGN_KW["policies"],
        duration_s=CAMPAIGN_KW["scenario_duration_s"], seed=CAMPAIGN_KW["seed"],
        jobs=1, device=CPU,
    )
    assert first.rows == direct


def test_sweep_cache_dir_routes_through_campaign(tmp_path):
    kw = dict(policies=("ads_tile",), duration_s=0.4, seed=4, jobs=1, device=CPU)
    rows = runner_t.sweep(2, cache_dir=tmp_path / "c", manifest_path=tmp_path / "m.json", **kw)
    assert rows == runner_t.sweep(2, **kw)
    assert CampaignManifest.load(tmp_path / "m.json").counts()["done"] == 2
    with pytest.raises(ValueError, match="cache_dir"):
        runner_t.sweep(1, manifest_path=tmp_path / "x.json", **kw)


def test_interrupted_campaign_resumes_row_for_row(tmp_path):
    ref = sweeps_ref.run_campaign(_campaign_ref(), cache_dir=tmp_path / "ref", jobs=1)
    cache, manifest = tmp_path / "cache", tmp_path / "manifest.json"
    _manifest(_campaign_t(), cache, manifest)
    report = run_shard(manifest, cache, max_groups=1, device=CPU)
    assert 0 < report["n_executed"] < 4
    resumed = run_campaign(str(manifest), jobs=1, device=CPU)
    assert resumed.n_cached == report["n_executed"]
    assert resumed.n_executed == 4 - report["n_executed"]
    assert resumed.rows == ref.rows


def test_failed_cells_are_captured_not_fatal(tmp_path):
    cache = tmp_path / "cache"
    bad = _campaign_t(policies=("ads_tile", "no_such_policy"))
    with pytest.raises(SweepFailure) as ei:
        run_campaign(bad, cache_dir=cache, manifest_path=tmp_path / "m.json",
                     jobs=1, device=CPU)
    result = ei.value.result
    assert result.n_failed == 2 and len(ei.value.failed_keys) == 2
    assert result.n_executed == 2
    manifest = CampaignManifest.load(tmp_path / "m.json")
    assert sorted(manifest.failed_keys()) == sorted(ei.value.failed_keys)
    good = run_campaign(_campaign_t(policies=("ads_tile",)), cache_dir=cache,
                        jobs=1, device=CPU)
    assert (good.n_executed, good.n_cached) == (0, 2)
    partial = run_campaign(bad, cache_dir=cache, jobs=1, allow_failures=True, device=CPU)
    assert partial.n_failed == 2 and len(partial.rows) == 2


def test_campaign_streaming_matches_kept_rows(tmp_path):
    kept = run_campaign(_campaign_t(), cache_dir=tmp_path / "c", jobs=1, device=CPU)
    streamed = run_campaign(_campaign_t(), cache_dir=tmp_path / "c", jobs=1,
                            keep_rows=False, device=CPU)
    assert streamed.rows is None
    assert streamed.aggregate == kept.aggregate


def test_subprocess_shards_run_the_ports_worker(tmp_path):
    ref = sweeps_ref.run_campaign(_campaign_ref(), cache_dir=tmp_path / "ref", jobs=1)
    res = run_campaign(
        _campaign_t(), cache_dir=tmp_path / "c", manifest_path=tmp_path / "m.json",
        executor=SubprocessShardExecutor(num_shards=2), device=CPU,
    )
    assert (res.n_executed, res.n_failed) == (4, 0)
    assert res.rows == ref.rows


def test_worker_cli_takes_a_device(tmp_path, capsys):
    cache, manifest = tmp_path / "cache", tmp_path / "m.json"
    _manifest(_campaign_t(n_scenarios=1, policies=("cyc",)), cache, manifest)
    assert worker_main([
        "--manifest", str(manifest), "--cache-dir", str(cache), "--device", CPU,
    ]) == 0
    report = json.loads(capsys.readouterr().out)
    assert (report["n_executed"], report["n_failed"]) == (1, 0)
    assert ResultCache(cache).get(report["cells"][0]["key"]) is not None


def test_soa_campaign_on_the_cpu(tmp_path):
    # the SoA backend through the service: cells keyed under soa_torch,
    # the device carried to the group runner; a spec outside the SoA
    # support set (predictive replan) falls back to an exact cell
    spec = _campaign_t(n_scenarios=1, policies=("ads_tile",), scenario_duration_s=0.3,
                       backend="soa")
    res = run_campaign(spec, cache_dir=tmp_path / "c", jobs=1, device=CPU)
    assert res.n_executed == 1
    assert {c.backend for c in res.manifest.cells} == {"soa_torch"}
    row = res.rows[0]
    assert row["policy"] == "ads_tile" and 0.0 <= row["violation_rate"] <= 1.0
    pred = _campaign_t(n_scenarios=1, policies=("ads_tile",), scenario_duration_s=0.3,
                       backend="soa", spec_kw={"replan_mode": "predictive"})
    assert {c.backend_class for c in build_cells(pred)} == {"exact"}


def test_campaign_spec_json_round_trip():
    gen = default_generator()
    spec = _campaign_t(generator=gen, spec_kw={"record": True, "tiles": 256})
    d = json.loads(json.dumps(spec.to_dict()))
    back = CampaignSpec.from_dict(d)
    assert back.policies == spec.policies and back.spec_kw == spec.spec_kw
    assert back.generator.transitions == gen.transitions
    assert back.to_dict() == spec.to_dict()
    assert d == json.loads(json.dumps(_campaign_ref(
        generator=default_generator_ref(), spec_kw={"record": True, "tiles": 256},
    ).to_dict()))


def test_manifest_version_guard_and_cache_corruption(tmp_path):
    res = run_campaign(_campaign_t(n_scenarios=1), cache_dir=tmp_path / "c",
                       manifest_path=tmp_path / "m.json", jobs=1, device=CPU)
    loaded = CampaignManifest.load(tmp_path / "m.json")
    assert loaded.counts() == res.manifest.counts()
    d = json.loads((tmp_path / "m.json").read_text())
    assert CampaignManifest.is_manifest(d)
    d["version"] = 99
    (tmp_path / "m.json").write_text(json.dumps(d))
    with pytest.raises(ValueError, match="version"):
        CampaignManifest.load(tmp_path / "m.json")
    cache = ResultCache(tmp_path / "k")
    cache.put("ab" * 32, {"x": 1.5})
    assert cache.get("ab" * 32) == {"x": 1.5}
    (tmp_path / "k" / "ab" / (("ab" * 32) + ".json")).write_text("{truncated")
    assert cache.get("ab" * 32) is None


# ---------------------------------------------------------------------------
# parallel_map error semantics
# ---------------------------------------------------------------------------
def _square(x):
    return x * x


def _boom(x):
    if x == 2:
        raise ValueError("boom on 2")
    return x


@pytest.mark.parametrize("jobs", [1, 2])
def test_parallel_map_return_errors_in_place(jobs):
    out = runner_t.parallel_map(_boom, [1, 2, 3], jobs=jobs, return_errors=True)
    assert out[0] == 1 and out[2] == 3
    assert isinstance(out[1], ItemFailure)
    assert "boom on 2" in out[1].error


def test_parallel_map_reraises_after_full_pass():
    with pytest.raises(ValueError, match="boom on 2"):
        runner_t.parallel_map(_boom, [1, 2, 3], jobs=1)
    assert runner_t.parallel_map(_square, [1, 2, 3], jobs=1) == [1, 4, 9]
