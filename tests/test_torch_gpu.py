"""The port on the card: the CUDA kernels (ladder grant, the fused EDF
allocator, flash attention,
MoE grouped matmul, SSD intra-chunk, RG-LRU scan, and the backwards of
the last four; the two tensor-core backwards also repeat bit for bit and
keep the designs they replace launchable) against their plain
versions, the torch sampler,
round loop, LM (every arch's stack and frontend, reduced; the MoE, SSM
and hybrid stacks' gradients) and serving
engine on CUDA against their CPU runs.
Every test here needs a CUDA device and skips without one.

This file imports only the port (no JAX), so it also runs on a machine
without the reference's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py
"""
import dataclasses
import warnings

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


def _alloc_case(R, W, C, P, seed, kind="", part_rows=None, cand_lanes=False, cap_rows=None):
    """tests/test_torch_soa_alloc.py's integer queues, at any R, on the card."""
    rng = np.random.default_rng(seed)
    shape = (R, W, C) if cand_lanes else (W, C)
    cand = np.sort(rng.integers(1, 49, size=shape), axis=-1).astype(np.float32)
    pad = rng.integers(1, C + 1, size=shape[:-1])
    cand = np.where(np.arange(C) >= pad[..., None], np.take_along_axis(
        cand, (pad - 1)[..., None], axis=-1), cand).astype(np.float32)
    pick = rng.integers(0, C, size=(R, W))
    want = np.take_along_axis(np.broadcast_to(cand, (R, W, C)), pick[..., None], -1)[..., 0]
    want = np.where(rng.random((R, W)) < 0.15, 0.0, want).astype(np.float32)
    entry = rng.random((R, W)) < 0.7
    part = rng.integers(-1, P + 1, size=(part_rows or R, W)).astype(np.float32)
    cap = rng.integers(0, 160, size=(cap_rows or R, P)).astype(np.float32)
    if kind == "empty":
        entry[:] = False
    elif kind == "want_high":
        want[:] = 1000.0
    elif kind == "pool_zero":
        cap[:] = 0.0
    perm = rng.permutation(W).astype(np.int64)
    return [torch.from_numpy(a).cuda() for a in (want, entry, part, cand, cap, perm)]


ALLOC_CASES = (
    [(P, C, W, "", None, False, None) for P in (1, 4, 21) for C in (1, 6)
     for W in (8, 96, 160, 300, 1520)]
    + [(P, 6, 160, k, None, False, None) for P in (1, 4)
       for k in ("empty", "want_high", "pool_zero")]
    + [(4, 6, 96, "", pr, cl, cr) for pr, cl, cr in
       ((1, False, None), (None, False, 1), (None, True, None), (1, True, 1))]
)


@pytest.mark.parametrize("P, C, W, kind, part_rows, cand_lanes, cap_rows", ALLOC_CASES)
def test_fused_alloc_kernel_equals_plain(cuda, P, C, W, kind, part_rows, cand_lanes, cap_rows):
    # R = 1024 as the main path runs; 128 lanes at the full-horizon window
    # (W = 1520), where the plain version's (R, W, W) masks would take 28 GB
    want, entry, part, cand, cap, perm = _alloc_case(
        1024 if W <= 300 else 128, W, C, P, seed=P * 1000 + C * 10 + W, kind=kind,
        part_rows=part_rows, cand_lanes=cand_lanes, cap_rows=cap_rows)
    for iters, bump in ((3, None), (8, 8)):
        before = K.edf_alloc_ladder.launches
        got = K.edf_alloc_ladder(want, entry, part, cand, cap, perm,
                                 alloc_iters=iters, bump_passes=bump)
        assert K.edf_alloc_ladder.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, K._edf_alloc_ladder(want, entry, part, cand, cap, perm,
                                                    iters, bump))
    d = torch.where(entry, want, torch.zeros_like(want))
    got = K.edf_start_keep(d, part, cap, perm)
    torch.cuda.synchronize()
    assert torch.equal(got, K._edf_start_keep(d, part, cap, perm))


def test_fused_alloc_kernel_equals_plain_on_main_path_problem(cuda, monkeypatch):
    """Every allocation of the first 60 rounds of the main path's problem
    (commute, cockpit_replicas=4, R=1024, the runner's window) for ads_tile
    and tp_driven, recorded on the card, then replayed through the kernel
    and the plain version."""
    seen = []
    alloc, keep = K._edf_alloc_ladder_cuda, K._edf_start_keep_cuda

    def rec_alloc(*a):
        seen.append(("alloc", [t.clone() for t in a[:6]], a[6:]))
        return alloc(*a)

    def rec_keep(*a):
        seen.append(("keep", [t.clone() for t in a], ()))
        return keep(*a)

    monkeypatch.setattr(K, "_edf_alloc_ladder_cuda", rec_alloc)
    monkeypatch.setattr(K, "_edf_start_keep_cuda", rec_keep)
    for policy in ("ads_tile", "tp_driven"):
        spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy,
                            cockpit_replicas=4)
        wf, model, sched, pf = runner._prepare_run(spec)
        dur = spec.scenario.duration_s
        prob = soa.build_problem(wf, model, sched, pf, runner._make_run_policy(spec, pf),
                                 spec.scenario, dur, n_lanes=1024)
        const = dict(prob.const)
        for k in ("t0", "t1", "seg", "lo", "entry", "perm", "iperm"):
            const[k] = const[k][:60]
        bt = sample_trace_batch(build_skeleton(wf, spec.scenario, dur), model,
                                spec.scenario, list(range(1024)), device="cuda")
        K.simulate(prob.cfg, const, soa._lanes(prob, bt), device="cuda")
    monkeypatch.undo()
    assert {k for k, _, _ in seen} == {"alloc", "keep"}
    for kind, args, extra in seen:
        if kind == "alloc":
            got, want = K._edf_alloc_ladder_cuda(*args, *extra), K._edf_alloc_ladder(*args, *extra)
        else:
            got, want = K._edf_start_keep_cuda(*args), K._edf_start_keep(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kind


def test_fused_alloc_kernel_refuses_bad_input(cuda):
    want, entry, part, cand, cap, perm = _alloc_case(4, 16, 3, 2, seed=1)
    kw = dict(alloc_iters=3, bump_passes=None)
    with pytest.raises(ValueError, match="cuda"):
        K.edf_alloc_ladder(want, entry, part, cand, cap.cpu(), perm, **kw)
    with pytest.raises(TypeError):
        K.edf_alloc_ladder(want.double(), entry, part, cand, cap, perm, **kw)
    big = 6000
    with pytest.raises(ValueError, match=f"W={big}"):
        K.edf_alloc_ladder(
            torch.zeros(2, big, device=cuda), torch.zeros(2, big, dtype=torch.bool, device=cuda),
            torch.zeros(1, big, device=cuda), torch.ones(big, 6, device=cuda),
            torch.ones(2, 4, device=cuda), torch.arange(big, device=cuda), **kw)


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
    before = K.edf_alloc_ladder.launches
    grants = K.ladder_grant.launches
    b = K.simulate(prob.cfg, prob.const, lanes, device="cuda")
    n_rounds = prob.const["t0"].shape[0]
    # one fused launch per allocation: ads_tile's Phase A, Phase B and
    # start validation, the others' one; the standalone grant never
    calls = 3 if policy == "ads_tile" else 1
    assert K.edf_alloc_ladder.launches - before == n_rounds * calls
    assert K.ladder_grant.launches == grants
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


def test_soa_sweep_on_cuda_matches_lockstep(cuda):
    """An SoA sweep on the card runs the fused allocator (counted in
    this process: jobs=1) and agrees with the lockstep sweep of the same
    cells on every structural fact; the rows name the same cells."""
    kw = dict(policies=("ads_tile", "tp_driven"), duration_s=0.7, jobs=1)
    reports, rows = {}, {}
    orig = runner.summarize
    for backend in ("soa", "lockstep"):
        out = reports[backend] = []
        runner.summarize = lambda spec, report, out=out: out.append(report) or orig(spec, report)
        try:
            before = K.edf_alloc_ladder.launches, K.ladder_grant.launches
            rows[backend] = runner.sweep(2, backend=backend, **kw)
            after = K.edf_alloc_ladder.launches, K.ladder_grant.launches
        finally:
            runner.summarize = orig
        assert after[1] == before[1]
        assert (after[0] > before[0]) == (backend == "soa")
    ident = {b: [(r["script"], r["policy"], r["seed"]) for r in rows[b]] for b in rows}
    assert ident["soa"] == ident["lockstep"] and len(ident["soa"]) == 4
    for a, b in zip(reports["lockstep"], reports["soa"]):
        assert soa.structural_invariants(a) == soa.structural_invariants(b)


def _soa_fans(spec, seed_sets):
    """``run`` of each seed set on the SoA backend with the registry on;
    the reports, the registry's snapshot and the allocated bytes after
    each fan."""
    from repro_torch.obs import metrics

    metrics.enable()
    metrics.reset()
    reports, after = [], []
    try:
        for seeds in seed_sets:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                reports.append(run(spec, seeds=seeds, backend="soa", fallback=False))
            torch.cuda.synchronize()
            after.append(torch.cuda.memory_allocated())
        snap = metrics.snapshot()
    finally:
        metrics.reset()
        metrics.enable(False)
    return reports, snap, after


def test_soa_loop_replays_every_round_but_the_first_as_graphs(cuda):
    """Each loop runs round 0 eagerly and captures once; every other round
    is replayed, and the fused allocator is still launched eagerly once
    per allocation."""
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="ads_tile",
                        cockpit_replicas=4, duration_s=0.5)
    before = K.edf_alloc_ladder.launches
    _, snap, _ = _soa_fans(spec, [list(range(64))])
    cnt, ph = snap["counters"], snap["phases"]
    loops = ph["soa_issue"]["n"]
    assert cnt["soa_graph_captures"] == loops == ph["soa_capture"]["n"]
    assert cnt["soa_graph_rounds"] == cnt["soa_rounds"] - loops
    assert K.edf_alloc_ladder.launches - before == cnt["soa_alloc_calls"] == 3 * cnt["soa_rounds"]


def test_soa_fans_leave_allocated_memory_where_the_first_left_it(cuda):
    """Three fans in one process: the graphs and what they hold are
    released with each loop."""
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy="ads_tile",
                        cockpit_replicas=4, duration_s=0.5)
    _, snap, after = _soa_fans(spec, [list(range(k * 256, (k + 1) * 256)) for k in range(3)])
    assert snap["counters"]["soa_graph_captures"] >= 3
    assert after[1] == after[0] and after[2] == after[0], after


@pytest.mark.parametrize("policy", ["ads_tile", "tp_driven", "cyc"])
def test_soa_graphs_keep_the_scalar_engine_s_structure_across_a_seam(cuda, policy):
    """The two-mode script of the registry's CPU tests (one hot-swap seam,
    taken eagerly between replays) on the card: each lane's structural
    invariants are the scalar engine's."""
    from repro_torch.scenarios import ScenarioScript
    from repro_torch.scenarios.script import ModeSegment

    script = ScenarioScript(name="obs-seam", segments=(
        ModeSegment(mode="urban", duration_s=0.05), ModeSegment(mode="highway", duration_s=0.05)))
    spec = ScenarioSpec(scenario=script, policy=policy, cockpit_replicas=4)
    seeds = [3, 1 << 31]
    [got], snap, _ = _soa_fans(spec, [seeds])
    assert snap["phases"]["soa_round.seam"]["n"] >= 1
    assert snap["counters"]["soa_graph_rounds"] > 0
    for s, r in zip(seeds, got):
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
    # tile edges of the tensor-core / split-KV design
    (2, 4, 4, 1, 100, 32, 70, 71, 0, 0.0),        # g = 1, D = 32, Lk off the tile
    (3, 4, 2, 1, 77, 64, 60, 61, 16, 0.0),        # g = 2, window, split keys
    (2, 16, 1, 1, 1000, 256, 900, 901, 0, 0.0),   # g = 16, D = 256, many splits
    (1, 8, 2, 40, 300, 128, 200, 240, 64, 0.0),   # g = 4 prefill at an offset
    (1, 16, 1, 300, 300, 256, 0, 300, 2048, 0.0),  # long MQA prefill, no split
    # the widths the kernel pads: phi-3-vision's D = 96 (to 128), stablelm's
    # D = 160 and the MLA prefill's D = 192 (to 256)
    (1, 32, 32, 40, 128, 96, 0, 40, 0, 0.0),      # phi-3-vision prefill
    (4, 32, 32, 1, 128, 96, 23, 24, 0, 0.0),      # phi-3-vision decode
    (1, 32, 8, 16, 128, 160, 0, 16, 0, 0.0),      # stablelm prefill
    (4, 32, 8, 1, 128, 160, 23, 24, 0, 0.0),      # stablelm decode
    (1, 128, 128, 16, 16, 192, 0, 16, 0, 0.0),    # MLA prefill
    (2, 32, 16, 1, 4624, 128, 4610, 4611, 4096, 50.0),  # gemma2 past its window
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
    (32, 1, 1024, 512, None),       # C in {1, 10, 320} at the serve width
    (32, 10, 1024, 512, None),
    (32, 320, 1024, 512, None),     # a 1024-token prefill's buckets
    # deepseek-v2's d_model: more than one panel of D
    (16, 8, 5120, 1536, None),      # its serve shape at 16 of its 160 experts
    (4, 20, 5120, 1536, None),      # 32 rows a pass
    (2, 8, 5120, 200, None),        # F no multiple of 64
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


@pytest.mark.parametrize("C", [8, 320])
def test_moe_gmm_kernel_on_model_scale_weights(cuda, C):
    """bf16 at granite-moe's width and init scale (dense_init: 1/sqrt(E),
    outputs ~1e2), where a float32 sum in another order may round a =
    bf16(silu(h) u) the other way: the kernel and the plain version are
    held to TOL's band with its absolute term scaled by the output's rms
    (chip_smoke.py ``TOL_MOE_MODEL``) against the float64 oracle and each
    other."""
    E, D, F = 32, 1024, 512
    x = _randn((E, C, D), torch.bfloat16, 40)
    wg, wu, wd = (_randn(s, torch.bfloat16, 41 + i, E ** -0.5)
                  for i, s in enumerate([(E, D, F), (E, D, F), (E, F, D)]))
    got = MG.moe_gmm(x, wg, wu, wd)
    plain, o64 = MG.moe_gmm_plain(x, wg, wu, wd), MG.moe_gmm_oracle64(x, wg, wu, wd)
    torch.cuda.synchronize()
    for a, b in ((got, o64), (plain, o64), (got, plain)):
        a, b = a.float(), b.float()
        band = 2e-2 * b.abs() + 2e-2 * b.pow(2).mean().sqrt()
        assert torch.isfinite(a).all() and bool(((a - b).abs() <= band).all())


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
    # the tensor-core design's edges: C = 40 and 256, H = 3 and 5, P = 8
    # and 128, N = 24 and 256, nb > 1
    (1, 3, 40, 5, 128, 256),
    (2, 3, 40, 5, 8, 24),
    (1, 3, 256, 5, 128, 24),
    (1, 2, 256, 3, 8, 256),
    (2, 2, 256, 3, 64, 128),
    (1, 2, 32, 3, 4, 16),           # P = 4: the CUDA cores in bf16 too
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


def test_ssd_kernel_reads_model_slices_in_place(cuda):
    """x, B and C sliced out of one projection (row stride > width) give
    what their contiguous copies give, on the tensor cores."""
    B, L, H, P, N = 1, 512, 6, 64, 128
    conv = H * P + 2 * N
    xbc = _randn((B, L, conv), torch.bfloat16, 20)
    x = xbc[..., :H * P].reshape(B, 2, 256, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, 2, 256, N)
    Cm = xbc[..., H * P + N:].reshape(B, 2, 256, N)
    dt = torch.nn.functional.softplus(_randn((B, 2, 256, H), torch.float32, 21))
    A = -torch.exp(_randn((H,), torch.float32, 22, 0.3))
    got = SSD.ssd_intra_chunk(x, dt, A, Bm, Cm)
    want = SSD.ssd_intra_chunk(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_launcher_refuses_a_plan_that_does_not_fit(cuda):
    """The tensor-core launch checks the plan it is given: its shared
    memory must be the source's own reckoning (the wrapper's), and the
    operands bf16 with P >= 8."""
    lib = SSD._cuda.load("ssd_intra_chunk", SSD._SIG)
    C, H, P, N = 256, 2, 64, 256
    x = torch.zeros((1, 1, C, H, P), dtype=torch.bfloat16, device="cuda")
    dt, A = torch.zeros((1, 1, C, H), device="cuda"), torch.zeros((H,), device="cuda")
    Bm = torch.zeros((1, 1, C, N), dtype=torch.bfloat16, device="cuda")
    out = [torch.zeros(n, device="cuda") for n in (C * H * P, H * P * N, H)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(n, dtype, smem, p=P):
        return lib.ssd_intra_chunk(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                                   Bm.data_ptr(), None, *(o.data_ptr() for o in out), 1, C, H,
                                   p, n, H * p, n, n, dtype, 1, smem, stream)

    assert call(128, 1, SSD.mma_smem_bytes(C, P, 128) - 16) != 0  # not its reckoning
    assert call(128, 0, SSD.mma_smem_bytes(C, P, 128)) != 0       # float32
    assert call(128, 1, SSD.mma_smem_bytes(C, 4, 128), p=4) != 0  # P < 8
    assert call(128, 1, SSD.mma_smem_bytes(C, P, 128)) == 0
    assert call(N, 1, SSD.mma_smem_bytes(C, P, N)) == 0
    torch.cuda.synchronize()


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
    # the chunked design's edges: L = 1 and 16 (the short-L form), 2047
    # and 2049 (chunks not dividing L), B = 4, W = 100 (a channel a thread)
    (1, 16, 4096), (4, 16, 100), (4, 1, 100),
    (1, 2047, 4096), (4, 2049, 256), (4, 2049, 100),
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
    (4, 16, 8, 256, 64, 5, 4096),       # split ranges of empty slots
    (2, 8, 2, 192, 128, 20, 4096),
    (2, 4, 4, 100, 32, 250, 4096),      # a ring off the tile, g = 1
    (4, 16, 1, 2048, 256, 3000, 2048),  # recurrentgemma past its window
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
                                  "recurrentgemma_9b", "gemma2_27b", "gemma3_4b",
                                  "stablelm_12b", "deepseek_v2_236b"])
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


@pytest.mark.parametrize("arch", ["phi3_vision_4p2b", "musicgen_large"])
def test_frontends_on_cuda_match_cpu(cuda, arch):
    """The patch prefill (then a decode step) and the codebook path on the
    card against the CPU, on the same reduced weights."""
    cfg = get_config(arch, reduced=True)
    p_cpu = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, "cuda")
    m = LM(cfg)
    rng = np.random.default_rng(1)
    shape = (2, cfg.num_codebooks, 9) if cfg.num_codebooks else (2, 9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    batch = {"tokens": toks[..., :8]}
    if cfg.num_patches:
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(np.float32))
    n = 8 + cfg.num_patches
    c_cpu, c_gpu = m.init_cache(2, n + 4, "cpu"), m.init_cache(2, n + 4, "cuda")
    a, c_cpu = m.prefill(p_cpu, batch, c_cpu)
    b, c_gpu = m.prefill(p_gpu, {k: v.cuda() for k, v in batch.items()}, c_gpu)
    torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    step = {"tokens": toks[..., 8:9]}
    a, c_cpu = m.decode_step(p_cpu, step, c_cpu, n)
    b, c_gpu = m.decode_step(p_gpu, {"tokens": step["tokens"].cuda()}, c_gpu, n)
    torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, cap", [
    (8, 24, 8, 128, 128, 128, 0, 128, 0, 0.0),      # phi4-mini's train shape
    (2, 24, 8, 40, 40, 128, 0, 40, 0, 0.0),         # a ragged row tile
    (1, 6, 2, 33, 70, 64, 37, 70, 16, 30.0),        # offsets, window, softcap
    (1, 4, 1, 50, 50, 256, 0, 50, 0, 0.0),          # D = 256
    (8, 16, 1, 128, 128, 256, 0, 128, 2048, 0.0),   # recurrentgemma's train shape: 8 head groups
    (2, 32, 8, 40, 40, 160, 0, 40, 0, 0.0),         # stablelm's D = 160
    (1, 16, 16, 70, 70, 192, 0, 70, 0, 0.0),        # MLA's D = 192
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, B, Hq, Hkv, Lq, Lk, D, qo, kvl,
                                                  w, cap):
    if dtype == torch.bfloat16:
        assert FA.bwd_path(dtype, D) == "mma"
    g = torch.Generator(device=cuda).manual_seed(Lq + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
    kw = dict(causal=True, window=w, softcap=cap, q_offset=qo, kv_valid_len=kvl)
    out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert FA.flash_attention_bwd.launches == before + 1
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)


@pytest.mark.parametrize("B, Hq, Hkv, L, D", [(8, 16, 1, 128, 256), (8, 24, 8, 128, 128),
                                               (1, 16, 1, 300, 192)])
def test_flash_attention_bwd_kernel_repeats_bit_for_bit(cuda, B, Hq, Hkv, L, D):
    """Two calls on the same inputs give the same bits (no atomics; the head
    groups' partials are summed in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(L + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, Hq, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    out, lse = FA.flash_attention(q, k, v, return_lse=True, window=2048)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    first = FA.flash_attention_bwd(q, k, v, out, lse, dout, window=2048)
    second = FA.flash_attention_bwd(q, k, v, out, lse, dout, window=2048)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [128, 256])
def test_flash_attention_bwd_cuda_core_design_matches_plain(cuda, D):
    """The CUDA-core design, launched by name in bf16 (the timing phase
    compares it with the tensor cores in the same call), gives the plain
    answer."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((2, 6, 70, D), (2, 2, 70, D), (2, 2, 70, D)))
    out, lse = FA.flash_attention(q, k, v, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = FA._flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True, window=0,
                                       softcap=0.0, scale=None, q_offset=0, kv_offset=0,
                                       kv_valid_len=None, design="fma")
    for a, b in zip(got, FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


def test_train_step_gives_every_leaf_a_gradient(cuda):
    """phi4-mini at full width, 2 layers, bf16: after one loss.backward()
    every parameter leaf has a finite, nonzero gradient (attention's
    projections get theirs through the backward kernel)."""
    from repro_torch.models.lm import train_step_fn

    cfg = dataclasses.replace(get_config("phi4_mini_3p8b"), num_layers=2)
    params = init_params(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    leaves = []

    def walk(t, name=""):
        for key, val in t.items():
            if isinstance(val, dict):
                walk(val, f"{name}{key}/")
            else:
                val.requires_grad_(True)
                leaves.append((name + key, val))

    walk(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda)
    n_fwd, n_bwd = FA.flash_attention.launches, FA.flash_attention_bwd.launches
    train_step_fn(cfg)(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}).backward()
    assert FA.flash_attention_bwd.launches - n_bwd == 2
    assert FA.flash_attention.launches - n_fwd == (4 if cfg.remat else 2)
    for name, p in leaves:
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        assert bool((p.grad != 0).any()), name


def _rel_max(got, want):
    """Max abs difference over want's largest entry."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


#: each gradient to a share of its largest entry: float32 sums in another
#: order; bf16 one rounding of each output on both sides
TOL_BWD_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E, C, D, F", [(4, 10, 64, 32), (3, 70, 40, 72), (2, 320, 1024, 512),
                                        (2, 8, 5120, 1536)])
def test_moe_gmm_bwd_kernel_matches_plain(cuda, dtype, E, C, D, F):
    g = torch.Generator(device=cuda).manual_seed(E * C + D)
    x = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    wg, wu = (torch.randn((E, D, F), generator=g, device=cuda).mul(D ** -0.5).to(dtype)
              for _ in range(2))
    wd = torch.randn((E, F, D), generator=g, device=cuda).mul(F ** -0.5).to(dtype)
    dy = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    before = MG.moe_gmm_bwd.launches
    got = MG.moe_gmm_bwd(x, wg, wu, wd, dy)
    assert MG.moe_gmm_bwd.launches == before + 1
    for a, b in zip(got, MG.moe_gmm_bwd_plain(x, wg, wu, wd, dy)):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_max(a, b) <= TOL_BWD_MAX[dtype]


@pytest.mark.parametrize("E, C, D, F", [(4, 320, 1024, 512), (2, 8, 5120, 1536),
                                        (3, 70, 40, 72)])
def test_moe_gmm_bwd_kernel_repeats_bit_for_bit(cuda, E, C, D, F):
    """bf16 on the tensor cores: two calls give the same bits (every dW tile
    sums its C bucket rows inside one block), and the CUDA-core design it
    replaces, launched by name, gives the plain answer too."""
    assert MG.moe_bwd_path(torch.bfloat16, D, F) == "mma"
    g = torch.Generator(device=cuda).manual_seed(E + C + D)
    x, dy = (torch.randn((E, C, D), generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    wg, wu = (torch.randn((E, D, F), generator=g, device=cuda).mul(D ** -0.5).to(torch.bfloat16)
              for _ in range(2))
    wd = torch.randn((E, F, D), generator=g, device=cuda).mul(F ** -0.5).to(torch.bfloat16)
    first = MG.moe_gmm_bwd(x, wg, wu, wd, dy)
    second = MG.moe_gmm_bwd(x, wg, wu, wd, dy)
    fma = MG._moe_gmm_bwd_cuda(x, wg, wu, wd, dy, design="fma")
    torch.cuda.synchronize()
    for a, b, c, w in zip(first, second, fma, MG.moe_gmm_bwd_plain(x, wg, wu, wd, dy)):
        assert torch.equal(a, b)
        assert _rel_max(c, w) <= TOL_BWD_MAX[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, nb, C, H, P, N", [(1, 2, 40, 3, 8, 24), (8, 1, 128, 80, 64, 128),
                                               (2, 4, 256, 5, 128, 256)])
@pytest.mark.parametrize("given", ["all", "y_only"])
def test_ssd_intra_chunk_bwd_kernel_matches_plain(cuda, dtype, B, nb, C, H, P, N, given):
    g = torch.Generator(device=cuda).manual_seed(C + H + P)
    x = torch.randn((B, nb, C, H, P), generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, nb, C, H), generator=g, device=cuda))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g, device=cuda))
    Bm, Cm = (torch.randn((B, nb, C, N), generator=g, device=cuda).to(dtype) for _ in range(2))
    grads = [torch.randn(s, generator=g, device=cuda)
             for s in ((B, nb, C, H, P), (B, nb, H, P, N), (B, nb, H))]
    if given == "y_only":
        grads[1:] = [None, None]
    before = SSD.ssd_intra_chunk_bwd.launches
    got = SSD.ssd_intra_chunk_bwd(x, dt, A, Bm, Cm, *grads)
    assert SSD.ssd_intra_chunk_bwd.launches == before + 1
    for a, b in zip(got, SSD.ssd_intra_chunk_bwd_plain(x, dt, A, Bm, Cm, *grads)):
        assert a.shape == b.shape
        assert _rel_max(a, b) <= TOL_BWD_MAX[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, L, W", [(8, 128, 4096), (2, 13, 4096), (1, 2047, 4096),
                                     (1, 2049, 4096), (4, 2049, 100), (4, 1, 100)])
def test_rglru_scan_bwd_kernel_matches_plain(cuda, dtype, B, L, W):
    g = torch.Generator(device=cuda).manual_seed(L + W)
    x, r, i = (torch.randn((B, L, W), generator=g, device=cuda).to(dtype) for _ in range(3))
    lam = torch.randn((W,), generator=g, device=cuda)
    h0 = torch.randn((B, W), generator=g, device=cuda).to(dtype)
    out, _ = RG.rglru_scan(x, r, i, lam, h0)
    dh = torch.randn((B, L, W), generator=g, device=cuda)
    dht = torch.randn((B, W), generator=g, device=cuda)
    before = RG.rglru_scan_bwd.launches
    got = RG.rglru_scan_bwd(x, r, i, lam, h0, out, dh, dht)
    assert RG.rglru_scan_bwd.launches == before + 1
    for a, b in zip(got, RG.rglru_scan_bwd_plain(x, r, i, lam, h0, out, dh, dht)):
        assert a.shape == b.shape
        assert _rel_max(a, b) <= TOL_BWD_MAX[dtype]


def _ssd_bwd_case(dev, B, nb, C, H, P, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, nb, C, H, P), generator=g, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((B, nb, C, H), generator=g, device=dev))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g, device=dev))
    Bm, Cm = (torch.randn((B, nb, C, N), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    grads = [torch.randn(s, generator=g, device=dev)
             for s in ((B, nb, C, H, P), (B, nb, H, P, N), (B, nb, H))]
    return (x, dt, A, Bm, Cm), grads


@pytest.mark.parametrize("design", ["mma", "fma"])
@pytest.mark.parametrize("mask", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("B, nb, C, H, P, N", [(8, 1, 128, 80, 64, 128), (2, 4, 256, 5, 64, 128),
                                               (2, 2, 40, 3, 8, 24), (1, 1, 13, 3, 16, 20)])
def test_ssd_intra_chunk_bwd_designs_match_plain(cuda, B, nb, C, H, P, N, mask, design):
    """bf16, the tensor-core design and the CUDA-core one it replaced (by
    name), under every combination of the three gradients."""
    args, grads = _ssd_bwd_case(cuda, B, nb, C, H, P, N, C + H + mask)
    gs = [t if mask >> k & 1 else None for k, t in enumerate(grads)]
    got = SSD._ssd_intra_chunk_bwd_cuda(*args, *gs, design=design)
    for a, b in zip(got, SSD.ssd_intra_chunk_bwd_plain(*args, *gs)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_max(a, b) <= TOL_BWD_MAX[torch.bfloat16]


@pytest.mark.parametrize("B, nb, C, H, P, N", [(8, 1, 128, 80, 64, 128), (2, 4, 256, 80, 64, 128)])
def test_ssd_intra_chunk_bwd_mma_repeats_bit_for_bit(cuda, B, nb, C, H, P, N):
    """Three launches, no atomics: two calls on the same inputs give the
    same bits, in place of x, B and C read as slices of one projection."""
    assert SSD.ssd_bwd_path(torch.bfloat16, C, P, N) == "mma"
    args, grads = _ssd_bwd_case(cuda, B, nb, C, H, P, N, C)
    x, dt, A, Bm, Cm = args
    # token rows of one projection, as the model hands them
    proj = torch.cat([x.reshape(B, nb, C, H * P), Bm, Cm], dim=-1)
    xs = proj[..., :H * P].unflatten(-1, (H, P))
    bs, cs = proj[..., H * P:H * P + N], proj[..., H * P + N:]
    first = SSD.ssd_intra_chunk_bwd(xs, dt, A, bs, cs, *grads)
    second = SSD.ssd_intra_chunk_bwd(xs, dt, A, bs, cs, *grads)
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, SSD.ssd_intra_chunk_bwd_plain(*args, *grads)):
        assert torch.equal(a, b)
        assert _rel_max(a, w) <= TOL_BWD_MAX[torch.bfloat16]


@pytest.mark.parametrize("design", ["vec", "scalar"])
@pytest.mark.parametrize("B, L, W", [(8, 128, 4096), (2, 13, 4096), (1, 2049, 4096),
                                     (2, 300, 512), (3, 7, 64)])
def test_rglru_scan_bwd_designs_match_plain_and_repeat(cuda, B, L, W, design):
    """bf16, the vectorised lanes and the first design (by name): the plain
    answer, and two calls give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(L + W + 1)
    x, r, i = (torch.randn((B, L, W), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    lam = torch.randn((W,), generator=g, device=cuda)
    h0 = torch.randn((B, W), generator=g, device=cuda).to(torch.bfloat16)
    out, _ = RG.rglru_scan(x, r, i, lam, h0)
    dh = torch.randn((B, L, W), generator=g, device=cuda)
    dht = torch.randn((B, W), generator=g, device=cuda)
    first = RG._rglru_scan_bwd_cuda(x, r, i, lam, h0, out, dh, dht, design=design)
    second = RG._rglru_scan_bwd_cuda(x, r, i, lam, h0, out, dh, dht, design=design)
    torch.cuda.synchronize()
    for a, b, w in zip(first, second, RG.rglru_scan_bwd_plain(x, r, i, lam, h0, out, dh, dht)):
        assert torch.equal(a, b)
        assert _rel_max(a, w) <= TOL_BWD_MAX[torch.bfloat16]


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_2p7b", "recurrentgemma_9b",
                                  "deepseek_v2_236b"])
def test_train_loss_and_grads_on_cuda_match_cpu(cuda, arch):
    """The reduced stack's loss and every gradient leaf, float32, on the card
    (the backward kernels) and on the CPU (their plain versions); mamba2 at
    seq 64 (four of its 16-token chunks)."""
    from repro_torch.models.lm import train_step_fn
    from repro_torch.training.data import DataConfig, synthetic_stream

    cfg = get_config(arch, reduced=True)
    params = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seq = 64 if cfg.family == "ssm" else 20
    batch = next(synthetic_stream(cfg, DataConfig(batch=2, seq_len=seq), device="cpu"))
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        p = {}

        def walk(t, out):
            for key, val in t.items():
                if isinstance(val, dict):
                    out[key] = {}
                    walk(val, out[key])
                else:
                    out[key] = val.detach().to(dev).requires_grad_(True)

        walk(params, p)
        loss = train_step_fn(cfg)(p, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses[dev] = loss.item()
        flat = []

        def leaves(t, name=""):
            for key in sorted(t):
                if isinstance(t[key], dict):
                    leaves(t[key], f"{name}{key}/")
                else:
                    flat.append((name + key, t[key].grad.cpu()))

        leaves(p)
        grads[dev] = flat
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for (name, a), (_, b) in zip(grads["cuda"], grads["cpu"]):
        assert _rel_max(a, b) <= 1e-4, name


# ---------------------------------------------------------------------------
# the mesh and the colocated server on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_world(cuda):
    """A one-rank NCCL process group, destroyed after the test."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite_moe_1b", "phi4_mini_3p8b", "mamba2_2p7b",
                                  "recurrentgemma_9b"])
def test_mesh_train_on_one_rank_is_bit_equal_to_no_mesh(nccl_world, arch):
    """``Trainer(mesh=(1, 1))`` on the card: every placement whole, so the
    kernels see the unsharded tensors and the run gives mesh=None's bits."""
    from repro_torch.distribution import ElasticMesh
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.data import DataConfig, synthetic_stream
    from repro_torch.training.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
    dcfg = DataConfig(batch=2, seq_len=32, seed=1)
    runs = []
    for mesh in (None, ElasticMesh(1).mesh_for()):
        t = Trainer(cfg, TrainConfig(steps=2, log_every=1), mesh=mesh, device="cuda")
        hist = t.fit(synthetic_stream(cfg, dcfg, device="cuda"))["history"]
        runs.append(([h["loss"] for h in hist], [
            (p.full_tensor() if mesh is not None else p).detach() for p in tree_leaves(t.params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_dtensor_never_reaches_a_kernel_wrapper(nccl_world):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distribution import ElasticMesh

    mesh = ElasticMesh(1).mesh_for()
    q = distribute_tensor(torch.randn(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16), mesh,
                          [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        FA.flash_attention(q, q, q)
    x = distribute_tensor(torch.randn(2, 8, 64, device="cuda", dtype=torch.bfloat16), mesh,
                          [Replicate(), Replicate()])
    w = distribute_tensor(torch.randn(2, 64, 32, device="cuda", dtype=torch.bfloat16), mesh,
                          [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        MG.moe_gmm(x, w, w, w.transpose(1, 2).contiguous())
    # through the dispatch layer it runs on the local shards
    before = FA.flash_attention.launches
    out = ops.flash_attention(q, q, q)
    assert FA.flash_attention.launches == before + 1
    assert torch.equal(out.full_tensor(), FA.flash_attention(q.to_local(), q.to_local(),
                                                             q.to_local()))


def test_colocated_server_runs_every_job_on_the_kernels(cuda):
    """The colocated server on reduced models on the card: every job runs
    (or is dropped by the server's rule) and each run launches the flash
    forward once per layer, ``moe_gmm`` once per MoE layer."""
    from repro_torch.serving import ColocatedServer, ServedModel

    models, layers = {}, {}
    for name, arch, part in (("perception", "phi4_mini_3p8b", 0),
                             ("planner", "granite_moe_1b", 0),
                             ("cockpit", "gemma3_4b", 1)):
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
        m = LM(cfg)
        p = init_params(cfg, device="cuda")

        def fwd(toks, m=m, p=p):
            with torch.no_grad():
                x = m.embed(p, {"tokens": toks})
                x, _ = m.backbone(p, x, positions=torch.arange(x.shape[1], device="cuda"))
                out = m.logits_last(p, x[:, -1])
            torch.cuda.synchronize()
            return out

        variants = {f"b{b}": ((lambda pl, b=b, f=fwd: f(torch.as_tensor(pl[:b], device="cuda"))),
                              0.001 * b) for b in (1, 4)}
        models[name] = ServedModel(name=name, variants=variants, partition=part, budget_s=1.0)
        layers[name] = (cfg.num_layers, cfg.num_layers if cfg.num_experts else 0)
    server = ColocatedServer(models, num_partitions=2)
    rng = np.random.RandomState(0)
    for _ in range(3):
        toks = rng.randint(0, 100, (4, 16)).astype(np.int32)
        server.submit("perception", toks, deadline_s=10.0,
                      done_cb=lambda _o, t=toks: server.submit("planner", t, deadline_s=10.0))
        server.submit("cockpit", toks, deadline_s=10.0)
    f0, m0 = FA.flash_attention.launches, MG.moe_gmm.launches
    log = server.run(duration_s=30.0)
    assert len(log) == 9 and not any(r["dropped"] for r in log)
    assert FA.flash_attention.launches - f0 == sum(layers[r["model"]][0] for r in log)
    assert MG.moe_gmm.launches - m0 == sum(layers[r["model"]][1] for r in log)
