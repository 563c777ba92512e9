"""The port on the card: the CUDA kernels (ladder grant, flash attention,
MoE grouped matmul) against their plain versions, the torch sampler,
round loop, LM and serving engine on CUDA against their CPU runs.
Every test here needs a CUDA device and skips without one.

This file imports only the port (no JAX), so it also runs on a machine
without the reference's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.sim import soa
from repro_torch.core.sim import soa_kernels as K
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import moe_gmm as MG
from repro_torch.models import LM, init_params
from repro_torch.scenarios import ScenarioSpec, get_scenario, run
from repro_torch.scenarios import runner
from repro_torch.serving import EngineConfig, Request, ServingEngine

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


#: kernel vs plain version: tests/test_kernels.py's tolerances
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, cap", [
    (1, 16, 8, 16, 128, 64, 0, 16, 0, 0.0),       # serve prefill
    (4, 16, 8, 1, 128, 64, 23, 24, 0, 0.0),       # serve decode
    (2, 8, 2, 96, 96, 32, 0, 96, 32, 0.0),        # kernel-test sweep, window
    (1, 4, 1, 256, 256, 128, 0, 256, 0, 50.0),    # kernel-test sweep, softcap, D=128
    (2, 8, 4, 3, 100, 64, 40, 43, 16, 0.0),       # ragged decode with a window
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, cap):
    q = _randn((B, Hq, Lq, D), dtype, 1)
    k = _randn((B, Hkv, Lk, D), dtype, 2)
    v = _randn((B, Hkv, Lk, D), dtype, 3)
    kw = dict(causal=True, window=w, softcap=cap, q_offset=qo, kv_valid_len=kvl)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **kw)
    assert FA.flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E, C, D, F, scale", [
    (32, 8, 1024, 512, None),       # serve shape
    (4, 64, 32, 64, 0.1),           # kernel-test sweep
    (8, 96, 16, 32, 0.1),
    (4, 10, 64, 32, None),          # reduced config, ragged capacity
])
def test_moe_gmm_kernel_matches_plain(cuda, dtype, E, C, D, F, scale):
    x = _randn((E, C, D), dtype, 4)
    wg = _randn((E, D, F), dtype, 5, scale or D ** -0.5)
    wu = _randn((E, D, F), dtype, 6, scale or D ** -0.5)
    wd = _randn((E, F, D), dtype, 7, scale or F ** -0.5)
    before = MG.moe_gmm.launches
    got = MG.moe_gmm(x, wg, wu, wd)
    assert MG.moe_gmm.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), MG.moe_gmm_plain(x, wg, wu, wd).float(), **TOL[dtype])


def _to(tree, device):
    return {k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "phi4_mini_3p8b"])
def test_lm_on_cuda_matches_cpu(cuda, arch):
    cfg = get_config(arch, reduced=True)
    p_cpu = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, "cuda")
    m = LM(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10)))
    c_cpu, c_gpu = m.init_cache(2, 32, "cpu"), m.init_cache(2, 32, "cuda")
    a, c_cpu = m.prefill(p_cpu, {"tokens": toks[:, :8]}, c_cpu)
    n0 = FA.flash_attention.launches
    b, c_gpu = m.prefill(p_gpu, {"tokens": toks[:, :8].cuda()}, c_gpu)
    assert FA.flash_attention.launches - n0 == cfg.num_layers
    torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    for pos in (8, 9):
        a, c_cpu = m.decode_step(p_cpu, {"tokens": toks[:, pos:pos + 1]}, c_cpu, pos)
        b, c_gpu = m.decode_step(p_gpu, {"tokens": toks[:, pos:pos + 1].cuda()}, c_gpu, pos)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_gpu["k"].cpu(), c_cpu["k"], rtol=1e-4, atol=1e-4)


def test_serving_engine_on_cuda_matches_cpu_tokens(cuda):
    cfg = get_config("granite_moe_1b", reduced=True)
    p_cpu = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32) for _ in range(6)]
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", _to(p_cpu, "cuda"))):
        eng = ServingEngine(cfg, p, EngineConfig(max_batch=4, max_len=64), device=dev)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=8) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        n0 = MG.moe_gmm.launches
        eng.run_until_drained()
        launched = MG.moe_gmm.launches - n0
        assert launched == (0 if dev == "cpu" else
                            cfg.num_layers * (eng.prefill_calls + eng.decode_calls))
        out[dev] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]
