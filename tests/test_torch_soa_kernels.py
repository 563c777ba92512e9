"""The port's SoA round loop and its ladder-grant step against the JAX
reference, on the CPU.

The ladder grant is compare and select, so its plain version must equal
the reference's bit for bit.  The round loop is fed the reference's own
problem and lane arrays (through ``problem_from_arrays``): tile counts
are small integers, exact in float32, and the loop has no
transcendental, so every decision — ``state`` and ``dop`` — must be
equal, and the exact event times ``fin`` equal to float32 rounding
(a few ulps: the two frameworks round ``start + rem * d`` chains in a
different order in rare cells).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sim import soa as soa_ref
from repro.core.sim import soa_kernels as K_ref
from repro.core.sim.batch import sample_trace_batch
from repro.core.sim.trace import build_skeleton
from repro.scenarios.runner import ScenarioSpec, _make_run_policy, _prepare_run
from repro.scenarios.script import get_scenario
from repro_torch.core.sim import soa as soa_t
from repro_torch.core.sim import soa_kernels as K_t

# the loops run many tiny ops: one intra-op thread each keeps parallel
# test workers from oversubscribing the cores
torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the ladder grant
# ---------------------------------------------------------------------------
def test_plain_ladder_grant_matches_reference():
    # the reference's own test inputs (tests/test_soa.py)
    rng = np.random.default_rng(0)
    limit = rng.integers(0, 9, size=(5, 16)).astype(np.float32)
    cand = np.sort(rng.integers(0, 9, size=(5, 16, 4)), axis=-1).astype(np.float32)
    cand[..., 0] = 0.0
    want = K_ref.ladder_grant_reference(limit, cand)
    got = K_t._ladder_grant(torch.from_numpy(limit), torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(K_ref._ladder_grant(jnp.asarray(limit), jnp.asarray(cand))), got
    )
    np.testing.assert_array_equal(K_t.ladder_grant_reference(limit, cand), got)


@pytest.mark.parametrize("layout", ["shared", "per_lane"])
@pytest.mark.parametrize("R, W, C", [(1, 8, 1), (7, 48, 6), (33, 144, 6), (4, 96, 3)])
def test_plain_ladder_grant_random_cases(layout, R, W, C):
    rng = np.random.default_rng(R * 1000 + W + C)
    limit = (rng.integers(-2, 40, size=(R, W)) + rng.choice(
        [0.0, 0.25, 0.5, 0.75], size=(R, W))).astype(np.float32)
    shape = (W, C) if layout == "shared" else (R, W, C)
    cand = np.sort(rng.integers(1, 33, size=shape), axis=-1).astype(np.float32)
    want = K_ref.ladder_grant_reference(limit, cand)
    got = K_t._ladder_grant(torch.from_numpy(limit), torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(K_ref._ladder_grant(jnp.asarray(limit), jnp.asarray(cand))), got
    )
    if layout == "shared":
        # the Pallas kernel's own answer (interpret mode) on the same inputs
        np.testing.assert_array_equal(
            np.asarray(K_ref._ladder_grant_pallas(
                jnp.asarray(limit), jnp.asarray(cand), interpret=True)),
            got,
        )


def test_dispatcher_takes_plain_version_on_cpu_only():
    limit = torch.tensor([[0.0, 3.0, 9.0]])
    cand = torch.tensor([[1.0, 2.0], [1.0, 4.0], [2.0, 8.0]])
    before = K_t.ladder_grant.launches
    out = K_t.ladder_grant(limit, cand)
    assert out.tolist() == [[0.0, 1.0, 8.0]]
    assert K_t.ladder_grant.launches == before  # no kernel ran


@pytest.mark.parametrize(
    "limit, cand, err",
    [
        (torch.zeros(2, 3, dtype=torch.float64), torch.ones(3, 2), TypeError),
        (torch.zeros(2, 3), torch.ones(4, 2), ValueError),
        (torch.zeros(2, 3), torch.ones(2, 4, 2), ValueError),
        (torch.zeros(3), torch.ones(3, 2), ValueError),
        (torch.zeros(3, 2).t(), torch.ones(3, 2), ValueError),
        (torch.zeros(2, 3), torch.ones(3, 0), ValueError),
    ],
)
def test_cuda_wrapper_validates_before_launch(limit, cand, err):
    with pytest.raises(err):
        K_t._ladder_grant_cuda(limit, cand)


# ---------------------------------------------------------------------------
# the round loop, fed the reference's exact problem
# ---------------------------------------------------------------------------
def _reference_cell(policy, duration, replicas=1, scenario="commute",
                    drop_policy="soft", knobs=None):
    spec = ScenarioSpec(
        scenario=get_scenario(scenario), policy=policy,
        cockpit_replicas=replicas, drop_policy=drop_policy,
    )
    wf, model, sched, pf = _prepare_run(spec)
    pol = _make_run_policy(spec, pf)
    for k, v in (knobs or {}).items():
        setattr(pol, k, v)
    prob = soa_ref.build_problem(
        wf, model, sched, pf, pol, spec.scenario,
        duration, n_lanes=len(SEEDS), drop_policy=drop_policy,
    )
    skel = build_skeleton(wf, spec.scenario, duration)
    btrace = sample_trace_batch(skel, model, spec.scenario, SEEDS)
    return prob, soa_ref._lanes(prob, btrace)


def _check_loop_matches_reference(prob, lanes):
    ref = K_ref.simulate(prob.cfg, prob.const, lanes)
    fields = {
        f.name: getattr(prob, f.name)
        for f in dataclasses.fields(prob) if f.name not in ("cfg", "const")
    }
    port = soa_t.problem_from_arrays(
        dataclasses.asdict(prob.cfg), prob.const, **fields
    )
    assert port.cfg.P == prob.cfg.P and port.cfg.W == prob.cfg.W
    got = K_t.simulate(port.cfg, port.const, lanes, device="cpu")
    np.testing.assert_array_equal(ref["state"], got["state"])
    np.testing.assert_array_equal(ref["dop"], got["dop"])
    np.testing.assert_array_equal(ref["deg"], got["deg"])
    np.testing.assert_array_equal(np.isinf(ref["fin"]), np.isinf(got["fin"]))
    np.testing.assert_allclose(ref["fin"], got["fin"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref["codes"], got["codes"], rtol=0, atol=1e-5)
    for k in ("n_realloc", "realloc_bytes", "dropped_work"):
        np.testing.assert_allclose(ref[k], got[k], rtol=1e-5, err_msg=k)
    for k in ("busy", "realloc"):
        # tile-second sums over the window: the reduction order differs
        np.testing.assert_allclose(ref[k], got[k], rtol=1e-5, atol=1e-4, err_msg=k)
    # the port's reports from those arrays equal the reference's
    # structurally, and in every decision-derived count
    ra = soa_ref._assemble_reports(prob, ref)
    rb = soa_t._assemble_reports(port, got)
    for a, b in zip(ra, rb):
        assert soa_ref.structural_invariants(a) == soa_t.structural_invariants(b)
        assert a.chain_count == b.chain_count
        assert a.chain_violations == b.chain_violations
        assert a.n_dropped == b.n_dropped and a.n_realloc == b.n_realloc


@pytest.mark.parametrize("policy", ["cyc", "tp_driven", "ads_tile"])
def test_round_loop_matches_reference(policy):
    # 0.8 s of the 2 s commute drive: crosses the 0.6 s urban->highway
    # hot-swap seam and keeps the file inside its CPU time budget
    _check_loop_matches_reference(*_reference_cell(policy, 0.8))


@pytest.mark.parametrize(
    "policy, kw",
    [
        # elastic cyc: no ERT gate, no sub-deadline termination
        ("cyc_s", {}),
        # drop_mode 2: hard e2e-deadline dequeue
        ("tp_driven", {"drop_policy": "hard"}),
        ("ads_tile", {"drop_policy": "hard"}),
        # ads ablations ride into the config: no admission gate, no
        # quota control (want = top rung), no slack sharing, a gate
        ("ads_tile", {"knobs": {"admission": False, "quota_control": False,
                                "slack_sharing": False, "realloc_gate": 2.0}}),
        # another workload shape: four cockpit replicas (wider window)
        ("ads_tile", {"replicas": 4}),
        # another scenario: sensor-rate churn seams
        ("tp_driven", {"scenario": "rate_churn"}),
    ],
)
def test_round_loop_matches_reference_other_branches(policy, kw):
    # 0.62 s: past the first seam of both scenarios, short enough for
    # the CPU budget
    _check_loop_matches_reference(*_reference_cell(policy, 0.62, **kw))


def test_problem_from_arrays_rejects_unknown_config():
    prob, _ = _reference_cell("cyc", 0.1)
    fields = {
        f.name: getattr(prob, f.name)
        for f in dataclasses.fields(prob) if f.name not in ("cfg", "const")
    }
    cfg = dict(dataclasses.asdict(prob.cfg), bogus=1)
    with pytest.raises(TypeError, match="bogus"):
        soa_t.problem_from_arrays(cfg, prob.const, **fields)
