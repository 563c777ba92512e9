"""The port's SoA backend, end to end through ``run``, against the JAX
reference's scalar engine run live in the same process.

The contract is the reference's own for its SoA backend
(``tests/test_soa.py``): exact structural invariants per seed, a pooled
chain-latency KS statistic <= 0.08, and overlapping CIs on violation
rate and realloc waste.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.scenarios import runner as runner_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.core.sim import soa, soa_kernels
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import BUNDLED_SCENARIOS, get_scenario


# the loops run many tiny ops: one intra-op thread each keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3]
KS_TOL = 0.08


def _pooled_latencies(reports):
    return [x for r in reports for ls in r.chain_latencies.values() for x in ls]


@pytest.mark.parametrize(
    "policy, replicas, duration_s",
    [
        pytest.param("cyc", 1, None, id="cyc"),
        pytest.param("tp_driven", 1, None, id="tp_driven"),
        pytest.param("ads_tile", 1, None, id="ads_tile"),
        # the paper's heaviest deployment, cockpit x9 (its partitions hold
        # 11.5 task streams each, so two rounds a 1 ms step), on the first
        # 0.7 s of the drive, past the urban -> highway seam: the whole
        # drive at its job window takes the CPU minutes
        pytest.param("ads_tile", 9, 0.7, id="ads_tile-x9"),
    ],
)
def test_soa_distributionally_equivalent_to_reference_scalar(policy, replicas, duration_s):
    spec_a = runner_ref.ScenarioSpec(
        scenario=get_scenario_ref("commute"), policy=policy,
        cockpit_replicas=replicas, duration_s=duration_s,
    )
    ref = [r for s in SEEDS for r in
           runner_ref.run(dataclasses.replace(spec_a, seed=s), backend="scalar")]
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario("commute"), policy=policy,
        cockpit_replicas=replicas, duration_s=duration_s,
    )
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


#: every bundled scenario the SoA backend runs, under every policy
_GRID_CASES = [
    (name, policy)
    for name in sorted(BUNDLED_SCENARIOS)
    for policy in sorted(soa_kernels.POLICY_IDS)
    if runner_t.soa_usable(
        runner_t.ScenarioSpec(scenario=get_scenario(name), policy=policy)
    )[0]
]


@pytest.mark.parametrize("scenario, policy", _GRID_CASES)
def test_the_derived_round_grid_is_one_round_a_step_at_cockpit_x4(scenario, policy):
    """At cockpit x4 every bundled scenario under every policy keeps the
    1 ms grid with one round a step and the policy's fixed-point steps,
    exactly as before the sub-rounds: the same rounds, so the same
    kernels."""
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario(scenario), policy=policy, cockpit_replicas=4
    )
    wf, model, sched, pf = runner_t._prepare_run(spec)
    duration = spec.scenario.duration_s
    problem = soa.build_problem(
        wf, model, sched, pf, runner_t._make_run_policy(spec, pf),
        spec.scenario, duration, n_lanes=2,
    )
    assert problem.cfg.subrounds == 1
    assert problem.cfg.alloc_iters == (8 if policy == "tp_driven" else 3)
    dt = soa.SoaOptions().dt_s
    t0 = []
    for a, b in problem.seg_span:
        n = max(1, int(math.ceil((b - a) / dt - 1e-9)))
        t0.extend(a + (b - a) * np.arange(n) / n)
    np.testing.assert_array_equal(problem.const["t0"], np.asarray(t0).astype(np.float32))


@pytest.mark.parametrize(
    "policy, replicas, want",
    [("ads_tile", 1, 1), ("ads_tile", 4, 1), ("ads_tile", 5, 1), ("ads_tile", 6, 2),
     ("ads_tile", 9, 2),
     ("tp_driven", 9, 1), ("cyc", 9, 1), ("cyc_s", 9, 1)],
)
def test_subrounds_follow_the_task_streams_a_partition_holds(policy, replicas, want):
    """ads_tile takes a second round a step once its four partitions hold
    more than eight DNN task streams each (cockpit x5: 30 tasks, x6: 34,
    x9: 46); the other policies keep one."""
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario("commute"), policy=policy, cockpit_replicas=replicas
    )
    wf, model, sched, pf = runner_t._prepare_run(spec)
    problem = soa.build_problem(
        wf, model, sched, pf, runner_t._make_run_policy(spec, pf),
        spec.scenario, 0.1, n_lanes=2,
    )
    assert problem.cfg.subrounds == want
    assert len(problem.const["t0"]) == 100 * want


def _x9_reports(duration_s):
    """The first ``duration_s`` of commute at cockpit x9 under ads_tile,
    SEEDS, from the SoA backend."""
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario("commute"), policy="ads_tile", cockpit_replicas=9,
        duration_s=duration_s,
    )
    return runner_t.run(spec, seeds=SEEDS, backend="soa", fallback=False, device="cpu")


def test_the_subrounds_bring_cockpit_x9_closer_to_the_engine(monkeypatch):
    """At cockpit x9 the repaired rounds (two a step, the engine's chunk
    grid) pool chain latencies closer to the reference's scalar engine
    than one round a step on the anchored grid, the loop as it stood
    before the sub-rounds (the first 0.5 s of the drive: 0.038 against
    0.063 when written)."""
    duration = 0.5
    spec_a = runner_ref.ScenarioSpec(
        scenario=get_scenario_ref("commute"), policy="ads_tile", cockpit_replicas=9,
        duration_s=duration,
    )
    ref = _pooled_latencies([r for s in SEEDS for r in
                             runner_ref.run(dataclasses.replace(spec_a, seed=s),
                                            backend="scalar")])
    ks_sub = soa.ks_statistic(ref, _pooled_latencies(_x9_reports(duration)))
    monkeypatch.setattr(soa, "_subrounds_for", lambda *a: 1)
    ks_one = soa.ks_statistic(ref, _pooled_latencies(_x9_reports(duration)))
    assert ks_sub < ks_one, (ks_sub, ks_one)


def test_the_chunk_grid_projection_syncs_where_the_engine_does():
    """Work left at a running job's last progress sync: the later of its
    last chunk event (k / 6 of the job) and its last freeze, resume or
    start (``adv``), as the engine holds it; the anchored grid of one
    round a step puts the chunk events at ``adv`` + k * d / 6 instead."""
    # a 6 ms job started at 0; the same resumed at 1.5 ms without a stall,
    # and at 2.2 ms; a job resized to 3 ms at 1 ms, now on a chunk event
    d = torch.tensor([[6.0, 6.0, 6.0, 3.0]])
    fin = torch.tensor([[6.0, 6.0, 6.0, 4.0]])
    adv = torch.tensor([[0.0, 1.5, 2.2, 1.0]])
    t1 = torch.tensor(2.5)
    got = soa_kernels._stale_on_chunk_grid(fin, t1, adv, d, 6)
    want = torch.tensor([[4 / 6, 4 / 6, 3.8 / 6, 0.5]])
    torch.testing.assert_close(got, want)
    # the anchored grid reads the resumed job's stale point at adv itself
    anchored = ((fin - t1) + torch.remainder((t1 - adv).clamp(min=0.0), d / 6)) / d
    assert anchored[0, 1] < got[0, 1]
    late = soa_kernels._stale_on_chunk_grid(fin, torch.tensor(5.0 + 1e-6), adv, d, 6)
    torch.testing.assert_close(late[0, 0], torch.tensor(1 / 6))


@pytest.mark.parametrize("replicas, calls", [(4, False), (9, True)])
def test_only_a_problem_of_subrounds_takes_the_chunk_grid(monkeypatch, replicas, calls):
    """The round loop's ads bid projects on the engine's chunk grid at
    cockpit x9 (two rounds a step) and keeps the reference loop's grid at
    cockpit x4."""
    seen = []
    grid = soa_kernels._stale_on_chunk_grid

    def spy(*a):
        seen.append(a[-1])
        return grid(*a)

    monkeypatch.setattr(soa_kernels, "_stale_on_chunk_grid", spy)
    spec = runner_t.ScenarioSpec(
        scenario=get_scenario("commute"), policy="ads_tile", cockpit_replicas=replicas,
        duration_s=0.02,
    )
    runner_t.run(spec, seeds=SEEDS[:2], backend="soa", fallback=False, device="cpu")
    assert bool(seen) == calls
    assert set(seen) <= {6}
