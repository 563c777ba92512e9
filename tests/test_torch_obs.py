"""The port's flight recorder, miss attribution, Chrome-trace export and
trace schema against the JAX reference, run live in the same process on
the CPU.

* recorder-on runs equal recorder-off runs (the hooks observe, they
  never steer), in the port and against the reference's reports;
* ``attribute_misses`` / ``attribution_report`` and
  ``chrome_trace(recorder)`` equal the reference's for the same runs,
  on the scalar engine and on a recorded lockstep lane;
* ``trace_schema.json`` is the reference's byte for byte, and the
  schema validator accepts and rejects what the reference's does.
"""
import dataclasses
import filecmp
import json
import os

import pytest
import torch

import repro.obs as obs_ref
import repro_torch.obs as obs_t
from repro.core.sim.batch import report_digest as digest_ref
from repro.scenarios import runner as runner_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.core.experiment import build_stack, make_policy
from repro_torch.core.sim import SimConfig, Simulator
from repro_torch.core.sim.batch import report_digest as digest_t
from repro_torch.obs.schema import load_schema, validate
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import get_scenario as get_scenario_t

torch.set_num_threads(1)

CPU = "cpu"
BUNDLED = ("calm_to_rush", "commute", "night_storm", "rate_churn")


def _pair(scenario="rate_churn", policy="ads_tile", seed=1, **kw):
    a = runner_ref.ScenarioSpec(scenario=get_scenario_ref(scenario), policy=policy, seed=seed, **kw)
    b = runner_t.ScenarioSpec(scenario=get_scenario_t(scenario), policy=policy, seed=seed, **kw)
    return a, b


def _recorded(scenario="rate_churn", policy="ads_tile", seed=1):
    """The same recorded scalar run in both packages: ``(ref, port)``,
    each ``(sim, recorder, report)``."""
    out = []
    for runner, obs, spec in zip(
        (runner_ref, runner_t), (obs_ref, obs_t), _pair(scenario, policy, seed)
    ):
        wf, model, sched, portfolio = runner._prepare_run(spec)
        rec = obs.TraceRecorder()
        sim = runner.Simulator(
            wf, model, sched, runner._make_run_policy(spec, portfolio),
            runner._sim_config(spec, None, rec),
        )
        report = sim.run()
        out.append((sim, rec, report))
    return out


# ---------------------------------------------------------------------------
# non-perturbation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", ["rate_churn", "night_storm"])
def test_recorder_does_not_perturb_reports(scenario):
    a, b = _pair(scenario)
    trace = runner_t.build_trace(b)
    b = dataclasses.replace(b, portfolio=runner_t.compile_portfolio(b))
    [off] = runner_t.run(b, trace=trace, backend="scalar", device=CPU)
    rec = obs_t.TraceRecorder()
    [on] = runner_t.run(b, trace=trace, recorders={0: rec}, backend="scalar", device=CPU)
    assert len(rec) > 0
    d_off, d_on = dataclasses.asdict(off), dataclasses.asdict(on)
    assert d_off.pop("attribution") is None
    assert d_on.pop("attribution") is not None
    assert d_off == d_on
    [ra] = runner_ref.run(a, backend="scalar", recorders={0: obs_ref.TraceRecorder()})
    assert digest_ref(ra) == digest_t(on)
    assert ra.attribution == on.attribution


def test_spec_record_attaches_a_recorder():
    a, b = _pair("commute", record=True)
    [ra] = runner_ref.run(a)
    [rb] = runner_t.run(b, device=CPU)
    assert rb.attribution is not None
    assert ra.attribution == rb.attribution
    assert digest_ref(ra) == digest_t(rb)


# ---------------------------------------------------------------------------
# attribution against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", BUNDLED)
@pytest.mark.parametrize("policy", ("ads_tile", "tp_driven"))
def test_attribution_equals_reference(name, policy):
    (sim_a, rec_a, _), (sim_b, rec_b, _) = _recorded(name, policy)
    miss_a = obs_ref.attribute_misses(sim_a, rec_a)
    miss_b = obs_t.attribute_misses(sim_b, rec_b)
    assert [dataclasses.asdict(m) for m in miss_a] == [
        dataclasses.asdict(m) for m in miss_b
    ]
    for m in miss_b:
        total = m.queueing_s + m.realloc_stall_s + m.restagger_s + m.duration_tail_s
        assert total == pytest.approx(m.lateness_s, abs=1e-9), m.chain
    assert obs_ref.attribution_report(sim_a, rec_a) == obs_t.attribution_report(sim_b, rec_b)
    assert obs_ref.summarize_attribution(miss_a) == obs_t.summarize_attribution(miss_b)


def test_attribute_misses_requires_a_recorder():
    _a, b = _pair("rate_churn")
    wf, _hw, model, compiler = build_stack(b)
    sched = compiler.compile(model, wf)
    sim = Simulator(wf, model, sched, make_policy("ads_tile"),
                    SimConfig(duration_s=0.2, seed=1))
    sim.run()
    with pytest.raises(ValueError):
        obs_t.attribute_misses(sim)


# ---------------------------------------------------------------------------
# Chrome-trace export against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["rate_churn", "night_storm", "degraded_commute"])
def test_chrome_trace_equals_reference(name, tmp_path):
    (_sa, rec_a, _), (_sb, rec_b, _) = _recorded(name)
    assert [dataclasses.astuple(e) for e in rec_a.events] == [
        dataclasses.astuple(e) for e in rec_b.events
    ]
    doc_a = obs_ref.chrome_trace(rec_a)
    doc_b = obs_t.chrome_trace(rec_b)
    assert doc_a == doc_b
    obs_t.validate_trace(doc_b)
    path = tmp_path / "trace.json"
    written = obs_t.export_chrome_trace(rec_b, str(path))
    assert written == doc_b
    reloaded = json.loads(path.read_text())
    obs_t.validate_trace(reloaded)
    assert reloaded["displayTimeUnit"] == "ms"
    starts = {e["id"] for e in reloaded["traceEvents"] if e["ph"] == "s"}
    ends = {e["id"] for e in reloaded["traceEvents"] if e["ph"] == "f"}
    assert starts == ends


def test_recorded_lockstep_lane_exports_as_reference():
    a, b = _pair("calm_to_rush")
    rec_a, rec_b = obs_ref.TraceRecorder(), obs_t.TraceRecorder()
    ra = runner_ref.run(a, seeds=[0, 7], backend="lockstep", recorders={1: rec_a})
    rb = runner_t.run(b, seeds=[0, 7], backend="lockstep", recorders={1: rec_b}, device=CPU)
    assert [digest_ref(r) for r in ra] == [digest_t(r) for r in rb]
    assert ra[1].attribution == rb[1].attribution
    assert obs_ref.chrome_trace(rec_a) == obs_t.chrome_trace(rec_b)


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------
def test_trace_schema_json_byte_identical():
    here = os.path.dirname(obs_t.__file__)
    there = os.path.dirname(obs_ref.__file__)
    assert filecmp.cmp(
        os.path.join(here, "trace_schema.json"),
        os.path.join(there, "trace_schema.json"),
        shallow=False,
    )
    assert load_schema() == obs_ref.schema.load_schema()
    assert load_schema()["required"] == ["traceEvents", "displayTimeUnit"]


def test_obs_exports_match_reference():
    assert obs_t.__all__ == obs_ref.__all__
    assert obs_t.EVENT_KINDS == obs_ref.EVENT_KINDS


@pytest.mark.parametrize("doc", [
    {},
    {"traceEvents": [], "displayTimeUnit": "ms"},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 1}],
     "displayTimeUnit": "parsec"},
    {"traceEvents": [{"ph": "Z", "name": "x", "pid": 1}],
     "displayTimeUnit": "ms"},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": True}],
     "displayTimeUnit": "ms"},
    {"traceEvents": [{"ph": "i", "name": 3, "pid": 1}],
     "displayTimeUnit": "ms"},
    {"traceEvents": [{"ph": "i", "pid": 1}],
     "displayTimeUnit": "ms"},
    {"traceEvents": [{"ph": "i", "name": "x", "pid": 1}],
     "displayTimeUnit": "ms",
     "otherData": {"k": 3}},
])
def test_schema_validator_rejects_as_reference(doc):
    with pytest.raises(obs_ref.SchemaError) as ea:
        obs_ref.validate_trace(doc)
    with pytest.raises(obs_t.SchemaError) as eb:
        obs_t.validate_trace(doc)
    assert str(ea.value) == str(eb.value)


def test_schema_validator_reports_paths():
    with pytest.raises(obs_t.SchemaError, match=r"\$\.a\[1\]"):
        validate({"a": [1, "x"]},
                 {"type": "object",
                  "properties": {"a": {"type": "array",
                                       "items": {"type": "integer"}}}})


# ---------------------------------------------------------------------------
# plumbing: summarize / sweep aggregation
# ---------------------------------------------------------------------------
def test_recorded_sweep_rows_aggregate_as_reference():
    kw = dict(policies=("ads_tile",), duration_s=1.0, seed=1, jobs=1, record=True)
    rows_a = runner_ref.sweep(2, **kw)
    rows_b = runner_t.sweep(2, device=CPU, **kw)
    assert rows_a == rows_b
    att = runner_t.aggregate_sweep(rows_b)["ads_tile"]["attribution"]
    assert att["n_recorded"] == 2
    assert att["n_late"] == sum(r["attribution"]["n_late"] for r in rows_b)
    assert runner_ref.aggregate_sweep(rows_a) == runner_t.aggregate_sweep(rows_b)
