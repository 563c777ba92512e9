"""The port's host stack against the JAX reference, run live in the same
process: schedule portfolios, SoA problems, the latency model's NumPy
half and the scalar engine must agree bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import latency_model as LM_ref
from repro.core.sim import soa as soa_ref
from repro.core.sim.batch import report_digest as digest_ref
from repro.scenarios import runner as runner_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.core import latency_model as LM_t
from repro_torch.core.gha.schedule import Schedule as Schedule_t
from repro_torch.core.sim import soa as soa_t
from repro_torch.core.sim.soa_kernels import POLICY_IDS
from repro_torch.core.sim.batch import report_digest as digest_t
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import BUNDLED_SCENARIOS
from repro_torch.scenarios.script import get_scenario as get_scenario_t


# the loops run many tiny ops: one intra-op thread each keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)

POLICIES = ["cyc", "tp_driven", "ads_tile"]


#: every bundled scenario x every policy the engines know
SCENARIOS = sorted(BUNDLED_SCENARIOS)
ALL_POLICIES = sorted(POLICY_IDS, key=POLICY_IDS.get)


def _specs(policy, scenario="commute", **kw):
    a = runner_ref.ScenarioSpec(scenario=get_scenario_ref(scenario), policy=policy, **kw)
    b = runner_t.ScenarioSpec(scenario=get_scenario_t(scenario), policy=policy, **kw)
    return a, b


@pytest.mark.parametrize("policy", POLICIES)
def test_portfolio_tables_equal(policy):
    a, b = _specs(policy)
    _, _, sched_a, pf_a = runner_ref._prepare_run(a)
    _, _, sched_b, pf_b = runner_t._prepare_run(b)
    assert sorted(pf_a.schedules) == sorted(pf_b.schedules)
    for mode in pf_a.schedules:
        ja = pf_a.schedules[mode].to_json()
        assert ja == pf_b.schedules[mode].to_json(), mode
        # a reference table carries across through its JSON form
        assert Schedule_t.from_json(ja).to_json() == ja
    assert sched_a.to_json() == sched_b.to_json()


@pytest.mark.parametrize("policy", POLICIES)
def test_build_problem_arrays_equal(policy):
    a, b = _specs(policy)
    probs = []
    for runner, soa, spec in ((runner_ref, soa_ref, a), (runner_t, soa_t, b)):
        wf, model, sched, pf = runner._prepare_run(spec)
        probs.append(soa.build_problem(
            wf, model, sched, pf, runner._make_run_policy(spec, pf),
            spec.scenario, spec.scenario.duration_s, n_lanes=4,
        ))
    pa, pb = probs
    assert sorted(pa.const) == sorted(pb.const)
    for k in pa.const:
        assert pa.const[k].dtype == pb.const[k].dtype, k
        np.testing.assert_array_equal(pa.const[k], pb.const[k], err_msg=k)
    cfg_a = dataclasses.asdict(pa.cfg)
    for knob in ("use_pallas", "pallas_interpret"):
        cfg_a.pop(knob)
    cfg_b = dataclasses.asdict(pb.cfg)
    # the port's rounds a dt_s step, which the reference lacks: one here
    assert cfg_b.pop("subrounds") == 1
    assert cfg_a == cfg_b
    for f in dataclasses.fields(pa):
        if f.name in ("cfg", "const"):
            continue
        va, vb = getattr(pa, f.name), getattr(pb, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif f.name == "skeleton_key":
            # holds each package's own ScenarioScript: equal by value
            assert repr(va) == repr(vb)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scalar_report_digest_equal(scenario, policy):
    a, b = _specs(policy, scenario, seed=0)
    [ra] = runner_ref.run(a, backend="scalar")
    [rb] = runner_t.run(b, backend="scalar", device="cpu")
    assert digest_ref(ra) == digest_t(rb)


def test_ndtri_and_quantiles_bit_identical():
    rng = np.random.default_rng(0)
    q = np.concatenate([
        rng.uniform(0, 1, 4000), [0.0, 1.0, 1e-300, 0.02425, 0.97575, 1 - 2**-53],
    ])
    np.testing.assert_array_equal(LM_ref.ndtri(q), LM_t.ndtri(q))
    for x in (0.0, 1.0, 0.01, 0.5, 0.99, 0.999999):
        assert LM_ref.ndtri(x) == LM_t.ndtri(x)
    ln_a, ln_b = LM_ref.LogNormal(3.0, 3.3), LM_t.LogNormal(3.0, 3.3)
    np.testing.assert_array_equal(ln_a.quantiles(q[:4000]), ln_b.quantiles(q[:4000]))
    se_a = LM_ref.ShiftedExponential(5e-6, 1e5)
    se_b = LM_t.ShiftedExponential(5e-6, 1e5)
    np.testing.assert_array_equal(se_a.quantiles(q), se_b.quantiles(q))


def test_latency_model_bounds_bit_identical():
    from repro.core.experiment import build_stack as stack_ref
    from repro_torch.core.experiment import build_stack as stack_t

    a, b = _specs("ads_tile")
    wf_a, _, model_a, _ = stack_ref(a)
    wf_b, _, model_b, _ = stack_t(b)
    tasks = tuple(sorted(wf_a.tasks))
    assert tasks == tuple(sorted(wf_b.tasks))
    dops = np.arange(1, len(tasks) + 1) % 7 + 1
    for q in (0.5, 0.9, 0.99):
        np.testing.assert_array_equal(
            model_a.bound_batch(tasks, q, dops), model_b.bound_batch(tasks, q, dops)
        )
        for t in tasks:
            task_a, task_b = wf_a.tasks[t], wf_b.tasks[t]
            if task_a.is_sensor:
                continue
            cands = task_a.dop_candidates()
            assert cands == task_b.dop_candidates()
            assert model_a.bound_ladder(t, q, cands) == model_b.bound_ladder(t, q, cands)
            assert model_a.pruned_candidates(task_a, q) == model_b.pruned_candidates(task_b, q)
