"""The port on the card: the CUDA ladder-grant kernel against its plain
version, the torch sampler and round loop on CUDA against their CPU
runs.  Every test here needs a CUDA device and skips without one.

This file imports only the port (no JAX), so it also runs on a machine
without the reference's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.sim import soa
from repro_torch.core.sim import soa_kernels as K
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.scenarios import ScenarioSpec, get_scenario, run
from repro_torch.scenarios import runner

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("layout", ["shared", "per_lane"])
@pytest.mark.parametrize("R, W, C", [(1, 8, 1), (7, 48, 6), (1024, 144, 6), (1024, 160, 6)])
def test_ladder_grant_kernel_equals_plain(cuda, layout, R, W, C):
    g = torch.Generator().manual_seed(R + W + C)
    limit = (torch.randint(-2, 40, (R, W), generator=g)
             + 0.25 * torch.randint(0, 4, (R, W), generator=g)).float()
    shape = (W, C) if layout == "shared" else (R, W, C)
    cand = torch.sort(torch.randint(1, 33, shape, generator=g).float(), -1).values
    limit, cand = limit.to(cuda), cand.to(cuda)
    before = K.ladder_grant.launches
    got = K.ladder_grant(limit, cand)
    assert K.ladder_grant.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, K._ladder_grant(limit, cand))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        K.ladder_grant_reference(limit.cpu().numpy(), cand.cpu().numpy()),
    )


def test_ladder_grant_kernel_refuses_bad_input(cuda):
    with pytest.raises(TypeError):
        K.ladder_grant(torch.zeros(2, 3, dtype=torch.float64, device=cuda),
                       torch.ones(3, 2, device=cuda))
    with pytest.raises(ValueError):
        K.ladder_grant(torch.zeros(2, 3, device=cuda), torch.ones(3, 2))


def _cell(policy, R=4, duration=1.0):
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy)
    wf, model, sched, pf = runner._prepare_run(spec)
    prob = soa.build_problem(
        wf, model, sched, pf, runner._make_run_policy(spec, pf), spec.scenario,
        duration, n_lanes=R,
    )
    skel = build_skeleton(wf, spec.scenario, duration)
    return spec, prob, skel, model


def test_cuda_sampler_matches_host(cuda):
    spec, _prob, skel, model = _cell("cyc")
    seeds = list(range(64))
    host = sample_trace_batch(skel, model, spec.scenario, seeds)
    dev = sample_trace_batch(skel, model, spec.scenario, seeds, device="cuda")
    for f in ("work", "io", "sensor_lat"):
        np.testing.assert_allclose(getattr(host, f), getattr(dev, f),
                                   rtol=1e-12, atol=1e-15, err_msg=f)


@pytest.mark.parametrize("policy", ["cyc", "tp_driven", "ads_tile"])
def test_cuda_loop_matches_cpu_loop(cuda, policy):
    spec, prob, skel, model = _cell(policy)
    bt = sample_trace_batch(skel, model, spec.scenario, [0, 1, 2, 3])
    lanes = soa._lanes(prob, bt)
    a = K.simulate(prob.cfg, prob.const, lanes, device="cpu")
    before = K.ladder_grant.launches
    b = K.simulate(prob.cfg, prob.const, lanes, device="cuda")
    n_rounds = prob.const["t0"].shape[0]
    calls = 2 if policy == "ads_tile" else 1
    assert K.ladder_grant.launches - before == n_rounds * calls * (1 + prob.cfg.alloc_iters)
    same = (a["state"] == b["state"]) & (a["dop"] == b["dop"])
    assert same.mean() >= 1 - 1e-3
    ok = same & np.isfinite(a["fin"])
    np.testing.assert_allclose(a["fin"][ok], b["fin"][ok], rtol=0, atol=1e-5)


def test_run_on_cuda_matches_scalar_structure(cuda):
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="ads_tile",
                        duration_s=0.7)
    got = run(spec, seeds=[0, 1], backend="soa", fallback=False)
    for s, r in zip([0, 1], got):
        [ref] = run(dataclasses.replace(spec, seed=s), backend="scalar")
        assert soa.structural_invariants(ref) == soa.structural_invariants(r)
