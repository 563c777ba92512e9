"""The port on the card: the CUDA kernels (ladder grant, flash attention,
MoE grouped matmul, SSD intra-chunk, RG-LRU scan) against their plain
versions, the torch sampler,
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
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import ssd as SSD
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


#: tests/test_kernels.py's SSD tolerances
TOL_SSD = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, nb, C, H, P, N", [
    (1, 4, 16, 4, 16, 16),          # kernel-test sweep
    (2, 3, 32, 8, 32, 32),
    (1, 4, 256, 80, 64, 128),       # mamba2-2.7b full width, L = 1024
    (1, 1, 16, 80, 64, 128),        # the serve prefill
    (2, 2, 40, 3, 8, 24),           # ragged tiles, odd head count
    (1, 1, 64, 2, 128, 256),        # widest P and N
])
def test_ssd_intra_chunk_kernel_matches_plain(cuda, dtype, B, nb, C, H, P, N):
    x = _randn((B, nb, C, H, P), dtype, 8)
    dt = torch.nn.functional.softplus(_randn((B, nb, C, H), torch.float32, 9))
    A = -torch.exp(_randn((H,), torch.float32, 10, 0.3))
    Bm, Cm = _randn((B, nb, C, N), dtype, 11), _randn((B, nb, C, N), dtype, 12)
    before = SSD.ssd_intra_chunk.launches
    got = SSD.ssd_intra_chunk(x, dt, A, Bm, Cm)
    assert SSD.ssd_intra_chunk.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, SSD.ssd_intra_chunk_plain(x, dt, A, Bm, Cm)):
        torch.testing.assert_close(g, w, **TOL_SSD[dtype])


@pytest.mark.parametrize("L", [16, 600, 1024])
def test_ssd_chunked_on_cuda_matches_cpu(cuda, L):
    g = torch.Generator().manual_seed(L)
    H, P, N = 8, 64, 128
    x = torch.randn((1, L, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((1, L, H), generator=g))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g))
    Bm, Cm = torch.randn((1, L, 1, N), generator=g), torch.randn((1, L, 1, N), generator=g)
    s0 = 0.1 * torch.randn((1, H, P, N), generator=g)
    want = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=256, init_state=s0)
    got = ops.ssd_chunked(*(t.cuda() for t in (x, dt, A, Bm, Cm)), chunk=256,
                          init_state=s0.cuda())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, **TOL_SSD[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, L, W", [
    (1, 64, 64), (2, 48, 128),      # kernel-test sweep
    (1, 2048, 4096),                # recurrentgemma-9b prefill
    (4, 1, 4096),                   # its decode step
    (3, 13, 100),                   # ragged width and length
])
def test_rglru_kernel_matches_plain(cuda, dtype, B, L, W):
    x, r, i = (_randn((B, L, W), dtype, s) for s in (13, 14, 15))
    lam = _randn((W,), torch.float32, 16)
    h0 = _randn((B, W), dtype, 17)
    before = RG.rglru_scan.launches
    got = RG.rglru_scan(x, r, i, lam, h0)
    assert RG.rglru_scan.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, RG.rglru_scan_plain(x, r, i, lam, h0)):
        torch.testing.assert_close(g, w, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Hq, Hkv, W, D, pos, window", [
    (4, 16, 1, 128, 256, 24, 2048),     # recurrentgemma decode, ring part-filled
    (4, 16, 1, 128, 256, 300, 2048),    # wrapped
    (2, 8, 2, 64, 64, 150, 48),         # window inside the ring, D <= 128
])
def test_flash_attention_kernel_with_ring_positions(cuda, dtype, B, Hq, Hkv, W, D, pos, window):
    q = _randn((B, Hq, 1, D), dtype, 18)
    k, v = _randn((B, Hkv, W, D), dtype, 19), _randn((B, Hkv, W, D), dtype, 20)
    idx = torch.arange(W, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, window=window, q_offset=pos,
              kv_positions=pos - torch.remainder(pos - idx, W))
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), FA.flash_attention_plain(q, k, v, **kw).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_d256_prefill(cuda, dtype):
    q = _randn((1, 16, 16, 256), dtype, 21)
    k, v = _randn((1, 1, 16, 256), dtype, 22), _randn((1, 1, 16, 256), dtype, 23)
    kw = dict(causal=True, window=2048, q_offset=0, kv_offset=0)
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), FA.flash_attention_plain(q, k, v, **kw).float(),
                               **TOL[dtype])


def _to(tree, device):
    return {k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(device)


@pytest.mark.parametrize("arch", ["granite_moe_1b", "phi4_mini_3p8b", "mamba2_2p7b",
                                  "recurrentgemma_9b"])
def test_lm_on_cuda_matches_cpu(cuda, arch):
    cfg = get_config(arch, reduced=True)
    p_cpu = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, "cuda")
    m = LM(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10)))
    c_cpu, c_gpu = m.init_cache(2, 32, "cpu"), m.init_cache(2, 32, "cuda")
    a, c_cpu = m.prefill(p_cpu, {"tokens": toks[:, :8]}, c_cpu)
    counted = {"ssm": SSD.ssd_intra_chunk, "hybrid": RG.rglru_scan}.get(
        cfg.family, FA.flash_attention)
    n0 = counted.launches
    b, c_gpu = m.prefill(p_gpu, {"tokens": toks[:, :8].cuda()}, c_gpu)
    # one launch per layer that runs the kernel (the hybrid's 4 of 5 are LRU)
    assert counted.launches - n0 == (4 if cfg.family == "hybrid" else cfg.num_layers)
    torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    for pos in (8, 9):
        a, c_cpu = m.decode_step(p_cpu, {"tokens": toks[:, pos:pos + 1]}, c_cpu, pos)
        b, c_gpu = m.decode_step(p_gpu, {"tokens": toks[:, pos:pos + 1].cuda()}, c_gpu, pos)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    for key in c_cpu:
        torch.testing.assert_close(c_gpu[key].cpu(), c_cpu[key], rtol=1e-4, atol=1e-4)


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
