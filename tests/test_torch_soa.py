"""The port's SoA backend, end to end through ``run``, against the JAX
reference's scalar engine run live in the same process.

The contract is the reference's own for its SoA backend
(``tests/test_soa.py``): exact structural invariants per seed, a pooled
chain-latency KS statistic <= 0.08, and overlapping CIs on violation
rate and realloc waste.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.scenarios import runner as runner_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.core.sim import soa
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import get_scenario


# the loops run many tiny ops: one intra-op thread each keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3]
KS_TOL = 0.08


def _pooled_latencies(reports):
    return [x for r in reports for ls in r.chain_latencies.values() for x in ls]


@pytest.mark.parametrize("policy", ["cyc", "tp_driven", "ads_tile"])
def test_soa_distributionally_equivalent_to_reference_scalar(policy):
    spec_a = runner_ref.ScenarioSpec(scenario=get_scenario_ref("commute"), policy=policy)
    ref = [r for s in SEEDS for r in
           runner_ref.run(dataclasses.replace(spec_a, seed=s), backend="scalar")]
    spec = runner_t.ScenarioSpec(scenario=get_scenario("commute"), policy=policy)
    got = runner_t.run(
        spec, seeds=SEEDS, backend="soa", fallback=False, device="cpu"
    )
    assert len(got) == len(SEEDS)
    for a, b in zip(ref, got):
        ia, ib = soa.structural_invariants(a), soa.structural_invariants(b)
        assert ia == ib, {f: (ia[f], ib[f]) for f in ia if ia[f] != ib[f]}
    ks = soa.ks_statistic(_pooled_latencies(ref), _pooled_latencies(got))
    assert ks <= KS_TOL, f"{policy}: pooled chain-latency KS {ks:.4f} > {KS_TOL}"
    for metric in ("violation_rate", "realloc_frac"):
        ci_ref = soa.mean_ci([getattr(r, metric) for r in ref])
        ci_got = soa.mean_ci([getattr(r, metric) for r in got])
        assert soa.intervals_overlap(ci_ref, ci_got, pad=1e-9), (metric, ci_ref, ci_got)


def test_window_overflow_detected_and_retried():
    """A job that slides out of the job window unresolved must surface
    as SoaWindowOverflow, never as silently truncated reports; the
    runner retries with a wider window.  A third of the drive (0.7 s, across
    the 0.6 s seam) keeps the four loop runs inside the file's CPU
    budget."""
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario("commute"), policy="tp_driven", duration_s=0.7
    )
    wf, model, sched, pf = runner_t._prepare_run(spec)
    scen = spec.scenario
    base = soa.build_problem(
        wf, model, sched, pf, "tp_driven", scen, 0.7, n_lanes=len(SEEDS),
    )
    # shrink the window to ~4 ms: normal jobs outlive it
    tight = soa.SoaOptions(life_pad_s=-(base.life - 4e-3))
    problem = soa.build_problem(
        wf, model, sched, pf, "tp_driven", scen, 0.7, n_lanes=len(SEEDS),
        options=tight,
    )
    assert problem.life < base.life
    btrace = sample_trace_batch(
        build_skeleton(wf, scen, 0.7), model, scen, SEEDS, device="cpu"
    )
    with pytest.raises(soa.SoaWindowOverflow):
        soa.run_problem(problem, btrace, SEEDS, device="cpu")

    with pytest.warns(RuntimeWarning, match="SoA job window"):
        got = runner_t.run(spec, seeds=SEEDS, backend="soa", fallback=False,
                           options=tight, device="cpu")
    want = runner_t.run(spec, seeds=SEEDS, backend="soa", fallback=False,
                        device="cpu")
    assert len(got) == len(SEEDS)
    for a, b in zip(want, got):
        assert soa.structural_invariants(a) == soa.structural_invariants(b)
        assert abs(a.violation_rate - b.violation_rate) <= 0.05
        assert np.isclose(a.effective_frac, b.effective_frac, rtol=1e-2)


def test_unsupported_spec_falls_back_to_scalar_or_raises():
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario("commute"), policy="cyc",
        replan_mode="predictive", duration_s=0.3,
    )
    assert not runner_t.soa_usable(spec)[0]
    with pytest.raises(soa.SoaUnsupported):
        runner_t.run(spec, seeds=[0], backend="soa", fallback=False, device="cpu")
    [got] = runner_t.run(spec, seeds=[5], backend="soa", fallback=True, device="cpu")
    [want] = runner_t.run(
        dataclasses.replace(spec, seed=5), backend="scalar", device="cpu"
    )
    assert got.chain_latencies == want.chain_latencies


def test_soa_supported_predicate():
    assert soa.soa_available()
    assert soa.soa_supported("cyc")
    assert soa.soa_supported("tp_driven", drop_policy="hard")
    assert not soa.soa_supported("unknown_policy")
    assert not soa.soa_supported("cyc", replan_mode="predictive")
    assert not soa.soa_supported("cyc", detection_delay_s=0.02)
    assert not soa.soa_supported("cyc", record=True)
