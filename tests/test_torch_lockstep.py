"""The port's lockstep engine and ``run()`` dispatch against the JAX
reference, run live in the same process on the CPU.

Contract: bit-identity.  ``run(spec, device="cpu")`` with no backend
gives the reference's ``run(spec)`` report (the default is ``"auto"``:
scalar for one run, lockstep for seed fans and trace-sharing groups),
and every lockstep lane equals both the reference's lockstep lane and
the port's scalar engine, compared through ``report_digest`` (every
float verbatim).
"""
import dataclasses

import pytest
import torch

from repro.core.sim.batch import report_digest as digest_ref
from repro.obs import TraceRecorder as TraceRecorder_ref
from repro.scenarios import runner as runner_ref
from repro.scenarios.script import default_generator as default_generator_ref
from repro.scenarios.script import get_scenario as get_scenario_ref
from repro_torch.core.sim import batch as batch_t
from repro_torch.core.sim import soa as soa_t
from repro_torch.core.sim.batch import report_digest as digest_t
from repro_torch.obs import TraceRecorder as TraceRecorder_t
from repro_torch.scenarios import runner as runner_t
from repro_torch.scenarios.script import default_generator as default_generator_t
from repro_torch.scenarios.script import get_scenario as get_scenario_t

torch.set_num_threads(1)

SEEDS = [0, 7]
CPU = "cpu"

#: the reference's fast subset (tests/test_batch.py) plus commute x
#: ads_tile, where a SoA default would give another violation rate
DEFAULT_CASES = [
    (scen, pol)
    for scen in ("calm_to_rush", "rate_churn")
    for pol in ("cyc", "tp_driven", "ads_tile")
] + [("commute", "ads_tile")]


def _pair(scenario, policy, **kw):
    a = runner_ref.ScenarioSpec(scenario=get_scenario_ref(scenario), policy=policy, **kw)
    b = runner_t.ScenarioSpec(scenario=get_scenario_t(scenario), policy=policy, **kw)
    return a, b


def _scalar_t(spec, seed):
    spec = dataclasses.replace(spec, seed=int(seed))
    return runner_t.run(spec, backend="scalar", device=CPU)[0]


def _spy_scalar_lanes(monkeypatch):
    """Record every sim that de-batches to the port's scalar fallback lane."""
    seen = []
    orig = batch_t._ScalarLane
    monkeypatch.setattr(
        batch_t, "_ScalarLane", lambda sim: seen.append(sim) or orig(sim),
    )
    return seen


def _spy_run_batch(monkeypatch):
    """Count the port's lockstep batches and their lane counts."""
    calls = []
    orig = runner_t.run_batch
    monkeypatch.setattr(
        runner_t, "run_batch", lambda sims: calls.append(len(sims)) or orig(sims),
    )
    return calls


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario,policy", DEFAULT_CASES)
def test_default_run_matches_reference(scenario, policy):
    a, b = _pair(scenario, policy)
    [ra] = runner_ref.run(a)
    [rb] = runner_t.run(b, device=CPU)
    assert digest_ref(ra) == digest_t(rb)


@pytest.mark.parametrize("policy", ["cyc", "tp_driven", "ads_tile"])
@pytest.mark.parametrize("scenario", ["calm_to_rush", "rate_churn"])
def test_lockstep_seed_fan_bit_identical(scenario, policy, monkeypatch):
    a, b = _pair(scenario, policy)
    ref = runner_ref.run(a, seeds=SEEDS, backend="lockstep")
    calls = _spy_run_batch(monkeypatch)
    got = runner_t.run(b, seeds=SEEDS, backend="lockstep", device=CPU)
    assert calls == [len(SEEDS)]
    for s, ra, rb in zip(SEEDS, ref, got):
        assert digest_ref(ra) == digest_t(rb), (scenario, policy, s)
        assert digest_t(_scalar_t(b, s)) == digest_t(rb), (scenario, policy, s)


@pytest.mark.parametrize("policy", ["cyc_s", "ads_tile"])
def test_auto_seed_fan_is_lockstep(policy, monkeypatch):
    a, b = _pair("commute", policy)
    ref = runner_ref.run(a, seeds=SEEDS)
    calls = _spy_run_batch(monkeypatch)
    got = runner_t.run(b, seeds=SEEDS, device=CPU)
    assert calls == [len(SEEDS)]
    assert [digest_ref(r) for r in ref] == [digest_t(r) for r in got]


def test_auto_groups_share_traces(monkeypatch):
    # two policies on one (scenario, seed), a third spec on another
    # seed: auto runs the pair as one lockstep batch, the odd one scalar
    specs = []
    for pol, seed in (("ads_tile", 3), ("tp_driven", 3), ("cyc", 4)):
        specs.append(_pair("calm_to_rush", pol, seed=seed))
    refs, ports = [a for a, _ in specs], [b for _, b in specs]
    assert runner_t._auto_groups(ports) == [[0, 1], [2]]
    # the reference hashes the mode objects, which hold dicts, so its
    # auto grouping cannot run; its answer for these groups is the
    # lockstep pair on one shared trace and the scalar single run
    with pytest.raises(TypeError, match="unhashable"):
        runner_ref._auto_groups(refs)
    ref = runner_ref.run(refs[:2], trace=runner_ref.build_trace(refs[0]))
    ref += runner_ref.run(refs[2])
    calls = _spy_run_batch(monkeypatch)
    got = runner_t.run(ports, device=CPU)
    assert calls == [2]
    for spec, ra, rb in zip(ports, ref, got):
        assert digest_ref(ra) == digest_t(rb)
        assert digest_t(runner_t.run(spec, backend="scalar", device=CPU)[0]) == digest_t(rb)
    # the same group forced through lockstep with one shared trace
    calls.clear()
    pair = ports[:2]
    got2 = runner_t.run(pair, backend="lockstep", trace=runner_t.build_trace(pair[0]), device=CPU)
    assert calls == [2]
    assert [digest_t(r) for r in got2] == [digest_t(r) for r in got[:2]]


def test_divergent_lane_falls_back_to_scalar(monkeypatch):
    # a predictive replanner is outside the fused cores' support set:
    # its lane (and only its lane) de-batches to the scalar engine's loop
    kws = [dict(seed=3), dict(seed=3, replan_mode="predictive")]
    refs = [_pair("calm_to_rush", "ads_tile", **kw)[0] for kw in kws]
    ports = [_pair("calm_to_rush", "ads_tile", **kw)[1] for kw in kws]
    ref = runner_ref.run(refs, backend="lockstep")
    seen = _spy_scalar_lanes(monkeypatch)
    got = runner_t.run(ports, backend="lockstep", device=CPU)
    assert len(seen) == 1 and seen[0].cfg.seed == 3
    assert not batch_t.fast_lane_supported(seen[0])
    for spec, ra, rb in zip(ports, ref, got):
        assert digest_ref(ra) == digest_t(rb)
        assert digest_t(runner_t.run(spec, backend="scalar", device=CPU)[0]) == digest_t(rb)


def test_recorder_lane_debatches(monkeypatch):
    a, b = _pair("calm_to_rush", "ads_tile")
    ref = runner_ref.run(
        a, seeds=SEEDS, backend="lockstep", recorders={1: TraceRecorder_ref()},
    )
    seen = _spy_scalar_lanes(monkeypatch)
    rec = TraceRecorder_t()
    got = runner_t.run(b, seeds=SEEDS, backend="lockstep", recorders={1: rec}, device=CPU)
    assert [sim.cfg.recorder is rec for sim in seen] == [True]
    assert got[0].attribution is None and got[1].attribution is not None
    assert got[1].attribution == ref[1].attribution
    for s, ra, rb in zip(SEEDS, ref, got):
        assert digest_ref(ra) == digest_t(rb)
        assert digest_t(_scalar_t(b, s)) == digest_t(rb)


def test_mixed_skeleton_batch_rejected():
    a = runner_t.ScenarioSpec(scenario=get_scenario_t("calm_to_rush"), policy="cyc")
    b = runner_t.ScenarioSpec(scenario=get_scenario_t("commute"), policy="cyc")
    with pytest.raises(ValueError, match="skeleton"):
        runner_t.run([a, b], backend="lockstep", device=CPU)


def test_soa_fallback_goes_to_lockstep(monkeypatch):
    # degraded_commute lies outside the SoA support set: fallback=True
    # runs the seed fan on lockstep (the reference's choice), and the
    # reports are the scalar engine's; fallback=False raises
    a, b = _pair("degraded_commute", "ads_tile")
    assert not runner_t.soa_usable(b)[0]
    calls = _spy_run_batch(monkeypatch)
    got = runner_t.run(b, seeds=SEEDS, backend="soa", device=CPU)
    assert calls == [len(SEEDS)]
    ref = runner_ref.run(a, seeds=SEEDS, backend="soa")
    for s, ra, rb in zip(SEEDS, ref, got):
        assert digest_ref(ra) == digest_t(rb)
        assert digest_t(_scalar_t(b, s)) == digest_t(rb)
    with pytest.raises(soa_t.SoaUnsupported):
        runner_t.run(b, seeds=SEEDS, backend="soa", fallback=False, device=CPU)


def test_backend_registry_matches_reference():
    assert runner_t.SWEEP_BACKENDS.names() == runner_ref.SWEEP_BACKENDS.names()
    for name in runner_ref.SWEEP_BACKENDS:
        r, t = runner_ref.SWEEP_BACKENDS[name], runner_t.SWEEP_BACKENDS[name]
        assert (r.kind, r.batched) == (t.kind, t.batched), name
    with pytest.raises(ValueError, match="unknown backend"):
        runner_t.run(_pair("commute", "cyc")[1], backend="vector", device=CPU)


# ---------------------------------------------------------------------------
# property test: random scenarios/workloads, port lockstep against the
# reference's lockstep and the port's scalar engine
try:
    from hypothesis import HealthCheck, given, settings, strategies as st
except ImportError:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_property_random_scenarios_match():
        pass
else:
    @given(
        gen_seed=st.integers(0, 1_000),
        run_seed=st.integers(0, 10_000),
        duration=st.floats(0.3, 0.6),
        policy=st.sampled_from(["cyc", "tp_driven", "ads_tile"]),
        replicas=st.integers(1, 2),
    )
    @settings(
        deadline=None,
        max_examples=8,
        suppress_health_check=[HealthCheck.too_slow],
    )
    def test_property_random_scenarios_match(
        gen_seed, run_seed, duration, policy, replicas
    ):
        a = runner_ref.ScenarioSpec(
            scenario=default_generator_ref().sample(duration, gen_seed),
            policy=policy, cockpit_replicas=replicas,
        )
        b = runner_t.ScenarioSpec(
            scenario=default_generator_t().sample(duration, gen_seed),
            policy=policy, cockpit_replicas=replicas,
        )
        seeds = [run_seed, run_seed + 1]
        ref = runner_ref.run(a, seeds=seeds, backend="lockstep")
        got = runner_t.run(b, seeds=seeds, backend="lockstep", device=CPU)
        for s, ra, rb in zip(seeds, ref, got):
            assert digest_ref(ra) == digest_t(rb), (gen_seed, policy, s)
            assert digest_t(_scalar_t(b, s)) == digest_t(rb), (gen_seed, policy, s)
