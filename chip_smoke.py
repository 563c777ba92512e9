#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py                 # every phase (the full check)
    python3 chip_smoke.py --only device,build,kernel   # a short first call

Phases, each printing one JSON line:

1. ``device``  — the card (and, on its own line, ``nvidia-smi``'s name and
   power limit);
2. ``build``   — builds every CUDA kernel of the port from ``src/``, all
   ``nvcc`` processes started together;
3. ``kernel``  — each kernel against its plain PyTorch version on the card:
   the ladder grant at the SoA path's widths (exact equality); flash
   attention and the MoE grouped matmul at the serve path's shapes, at the
   reference's kernel-test sweep shapes and through offset / ragged-cache
   decode cases, in bf16 and f32 (tolerances ``TOL``);
4. ``sampler`` — the torch trace sampler on the card against the NumPy
   host path (R=1024, ``rtol=1e-12``);
5. ``main``    — ``run(commute, ads_tile, cockpit_replicas=4, seeds=range
   (1024), backend="soa")`` on the card, cold and warm, with every launch
   counter set to 0 just before the warm run and read just after;
6. ``loop``    — the round loop on the card against the same loop on the
   CPU (which the CPU tests hold against the JAX reference);
7. ``equiv``   — SoA on the card against the port's own scalar engine
   (structural invariants exact, pooled KS <= 0.08, CI overlap);
8. ``profile`` — device busy share of the round loop (torch.profiler over
   the main path's first 100 rounds at R=1024) and the grant kernel's
   device time;
9. ``serve``   — the LM serving path: ``ServingEngine`` on granite-moe-1b
   at full width in bf16 (random weights from seed 0) with the reference
   launcher's traffic (12 requests, prompt 16, 16 new tokens, batch 4,
   max_len 128), every launch counter set to 0 just before and read just
   after; tokens/s, request and first-token latency, weight bytes; a
   profiled window of decode steps (``serve_profile``); one request's
   prefill and 4 decode steps held against the port's CPU path on the same
   weights, widened to float32 on both sides (``serve_xcheck``);
10. ``timing`` — kernel, plain-version, library and bound times at each
   path's shapes, then the ``kernels`` line.

Any failed check exits non-zero.  Without a CUDA device it exits 2 before
printing any result.  The last line is ``{"ok": true, "device": ...}``.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import _cuda  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import LM, init_params  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.core.sim import soa  # noqa: E402
from repro_torch.core.sim import soa_kernels as K  # noqa: E402
from repro_torch.core.sim.batch import sample_trace_batch  # noqa: E402
from repro_torch.core.sim.trace import build_skeleton  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.scenarios import ScenarioSpec, get_scenario, run  # noqa: E402
from repro_torch.scenarios import runner  # noqa: E402

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, non-tensor fp32 rate and
#: dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

PHASES = ("device", "build", "kernel", "sampler", "main", "loop", "equiv",
          "profile", "serve", "timing")
KERNELS = ("ladder_grant", "flash_attention", "moe_gmm")
MAIN_R = 1024
KS_TOL = 0.08
T_START = time.perf_counter()


def emit(phase, **kw):
    kw = {"phase": phase, **kw, "t_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(kw), flush=True)


def check(ok, msg):
    if not ok:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(fn, iters=200, warmup=20):
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main_spec(**kw):
    return ScenarioSpec(
        scenario=get_scenario("commute"), policy="ads_tile", cockpit_replicas=4, **kw
    )


def main_problem(spec, R):
    """The SoA problem the main path ran (same window pad the runner
    settled on), for its shapes and round count."""
    wf, model, sched, pf = runner._prepare_run(spec)
    dur = spec.scenario.duration_s
    skel = build_skeleton(wf, spec.scenario, dur)
    pad = runner._SOA_LIFE_PAD_HINT.get(
        (skel.key, spec.policy, spec.drop_policy, float(dur)), 0.0
    )
    return soa.build_problem(
        wf, model, sched, pf, runner._make_run_policy(spec, pf), spec.scenario,
        dur, replan=spec.replan, n_lanes=R, drop_policy=spec.drop_policy,
        options=soa.SoaOptions(life_pad_s=pad),
    )


def ladder_inputs(R, W, C, layout, seed, ladder=None):
    """Random tile budgets against integer DoP ladders (sorted, padded by
    repeating the last rung, as build_problem pads them)."""
    g = torch.Generator().manual_seed(seed)
    limit = (torch.randint(-2, 40, (R, W), generator=g).float()
             + 0.25 * torch.randint(0, 4, (R, W), generator=g).float())
    if ladder is None:
        shape = (W, C) if layout == "shared" else (R, W, C)
        ladder = torch.sort(torch.randint(1, 33, shape, generator=g).float(), -1).values
    return limit.cuda(), ladder.contiguous().cuda()


# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
    return line


def phase_build():
    t = time.perf_counter()
    libs = _cuda.build(KERNELS)
    emit("build", seconds=time.perf_counter() - t,
         libs={k: os.path.basename(str(v)) for k, v in libs.items()},
         ptxas={k: v.strip().splitlines()[-6:] for k, v in _cuda.BUILD_LOG.items()})


#: kernel vs plain version: the reference's kernel-test tolerances
#: (tests/test_kernels.py ``_tol``): bf16 rounds each output once in both
#: versions, so they may differ by an ulp of bf16 (2^-8 relative)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = (torch.bfloat16, torch.float32)


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _held(got, want, dtype, what):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL[dtype]), f"{what}: max abs err {err}")
    return err


#: (name, B, Hq, Hkv, Lq, Lk, D, q_offset, kv_valid_len, window, softcap);
#: the serve path's prefill and decode (granite-moe-1b: 16 query heads,
#: 8 KV heads of width 64, a 128-row cache), tests/test_kernels.py's sweep
#: (q at offset 0, every key valid), and ragged / windowed decode cases
FLASH_CASES = (
    [("serve_prefill", 1, 16, 8, 16, 128, 64, 0, 16, 0, 0.0),
     ("serve_decode", 4, 16, 8, 1, 128, 64, 23, 24, 0, 0.0),
     ("prefill_40_rows", 1, 16, 8, 40, 128, 64, 0, 40, 0, 0.0),
     ("decode_window", 2, 8, 4, 3, 100, 64, 40, 43, 16, 0.0),
     ("decode_softcap_d128", 3, 4, 1, 1, 70, 128, 65, 66, 0, 30.0)]
    + [(f"sweep_{b}x{hq}x{hkv}x{l}x{d}_w{w}_c{int(c)}", b, hq, hkv, l, l, d, 0, l, w, c)
       for (b, hq, hkv, l, d) in [(1, 4, 4, 128, 64), (2, 8, 2, 96, 32), (1, 4, 1, 256, 128)]
       for (w, c) in [(0, 0.0), (32, 0.0), (0, 50.0)]]
)

#: (name, E, C, D, F, weight scale): the serve path (granite-moe-1b:
#: 32 experts, capacity 8, d_model 1024, d_ff 512; weights at the model's
#: init scale), tests/test_kernels.py's sweep, the reduced config
MOE_CASES = [
    ("serve", 32, 8, 1024, 512, None),
    ("sweep_4x64x32x64", 4, 64, 32, 64, 0.1),
    ("sweep_8x96x16x32", 8, 96, 16, 32, 0.1),
    ("reduced_4x10x64x32", 4, 10, 64, 32, None),
]


def flash_inputs(B, Hq, Hkv, Lq, Lk, D, dtype, seed):
    return (_randn((B, Hq, Lq, D), dtype, seed),
            _randn((B, Hkv, Lk, D), dtype, seed + 1),
            _randn((B, Hkv, Lk, D), dtype, seed + 2))


def moe_inputs(E, C, D, Fd, scale, dtype, seed):
    sd = scale if scale is not None else D ** -0.5
    sf = scale if scale is not None else Fd ** -0.5
    return (_randn((E, C, D), dtype, seed),
            _randn((E, D, Fd), dtype, seed + 1, sd),
            _randn((E, D, Fd), dtype, seed + 2, sd),
            _randn((E, Fd, D), dtype, seed + 3, sf))


def phase_kernel(errs):
    for W in (96, 144):
        for layout in ("shared", "per_lane"):
            limit, cand = ladder_inputs(MAIN_R, W, 6, layout, seed=W)
            got = K.ladder_grant(limit, cand)
            want = K._ladder_grant(limit, cand)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["ladder_grant"].append(err)
            check(torch.equal(got, want), f"ladder_grant W={W} {layout}: max err {err}")
            ref = K.ladder_grant_reference(limit.cpu().numpy(), cand.cpu().numpy())
            check(np.array_equal(got.cpu().numpy(), ref), "ladder_grant vs NumPy oracle")
    emit("kernel", name="ladder_grant", shapes="R=1024 W=96,144 C=6, (W,C) and (R,W,C)",
         exact=True, max_abs_err=max(errs["ladder_grant"]))

    res = {}
    for i, (name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, c) in enumerate(FLASH_CASES):
        for dtype in DTYPES:
            q, k, v = flash_inputs(B, Hq, Hkv, Lq, Lk, D, dtype, seed=100 + 10 * i)
            kw = dict(causal=True, window=w, softcap=c, q_offset=qo, kv_valid_len=kvl)
            before = FA.flash_attention.launches
            got = FA.flash_attention(q, k, v, **kw)
            check(FA.flash_attention.launches == before + 1, f"flash {name}: no launch")
            err = _held(got, FA.flash_attention_plain(q, k, v, **kw), dtype,
                        f"flash_attention {name} {dtype}")
            if name.startswith("sweep"):
                _held(got, kref.attention_ref(q.float(), k.float(), v.float(), window=w,
                                              softcap=c), dtype,
                      f"flash_attention {name} {dtype} vs attention_ref")
            errs["flash_attention"].append(err)
            res[f"{name}/{str(dtype)[6:]}"] = err
    emit("kernel", name="flash_attention", cases=len(res), tol={str(k)[6:]: v for k, v in TOL.items()},
         max_abs_err=max(errs["flash_attention"]), max_abs_err_by_case=res)

    res = {}
    for i, (name, E, C, D, Fd, scale) in enumerate(MOE_CASES):
        for dtype in DTYPES:
            x, wg, wu, wd = moe_inputs(E, C, D, Fd, scale, dtype, seed=500 + 10 * i)
            before = MG.moe_gmm.launches
            got = MG.moe_gmm(x, wg, wu, wd)
            check(MG.moe_gmm.launches == before + 1, f"moe_gmm {name}: no launch")
            err = _held(got, MG.moe_gmm_plain(x, wg, wu, wd), dtype, f"moe_gmm {name} {dtype}")
            _held(got, kref.moe_gmm_ref(x, wg, wu, wd), dtype, f"moe_gmm {name} {dtype} vs ref")
            errs["moe_gmm"].append(err)
            res[f"{name}/{str(dtype)[6:]}"] = err
    emit("kernel", name="moe_gmm", cases=len(res), tol={str(k)[6:]: v for k, v in TOL.items()},
         max_abs_err=max(errs["moe_gmm"]), max_abs_err_by_case=res)


def phase_sampler():
    spec = main_spec()
    wf, model, _s, _p = runner._prepare_run(spec)
    skel = build_skeleton(wf, spec.scenario, spec.scenario.duration_s)
    seeds = list(range(MAIN_R))
    t = time.perf_counter()
    host = sample_trace_batch(skel, model, spec.scenario, seeds)
    host_s = time.perf_counter() - t
    sample_trace_batch(skel, model, spec.scenario, seeds[:4], device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    dev = sample_trace_batch(skel, model, spec.scenario, seeds, device="cuda")
    dev_s = time.perf_counter() - t
    worst = 0.0
    for f in ("work", "io", "sensor_lat"):
        a, b = getattr(host, f), getattr(dev, f)
        check(np.allclose(a, b, rtol=1e-12, atol=1e-15), f"sampler field {f}")
        nz = a != 0
        if nz.any():
            worst = max(worst, float(np.max(np.abs(a[nz] - b[nz]) / np.abs(a[nz]))))
    emit("sampler", R=MAIN_R, n=int(skel.n), host_numpy_s=host_s,
         cuda_s_incl_copy_back=dev_s, max_rel_err=worst)


def _means(reports):
    return {
        "violation_rate": float(np.mean([r.violation_rate for r in reports])),
        "realloc_frac": float(np.mean([r.realloc_frac for r in reports])),
        "tiles_reserved_mean": float(np.mean([r.tiles_reserved_mean for r in reports])),
        "effective_frac": float(np.mean([r.effective_frac for r in reports])),
    }


def _run_main(spec, seeds):
    metrics.enable()
    metrics.reset()
    K.ladder_grant.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = time.perf_counter()
        reports = run(spec, seeds=seeds, backend="soa", fallback=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = K.ladder_grant.launches
    snap = metrics.snapshot()
    metrics.enable(False)
    retries = sum("SoA job window" in str(w.message) for w in caught)
    return reports, wall, launches, snap, retries


def phase_main():
    spec = main_spec()
    seeds = list(range(MAIN_R))
    out = {}
    for tag in ("cold", "warm"):
        reports, wall, launches, snap, retries = _run_main(spec, seeds)
        problem = main_problem(spec, MAIN_R)
        cfg = problem.cfg
        rounds = int(snap["counters"].get("soa_rounds", 0))
        per_round = 2 * (1 + cfg.alloc_iters)  # two _alloc_ladder calls (ads)
        check(rounds == (1 + retries) * problem.const["t0"].shape[0],
              f"{tag}: {rounds} rounds for {retries} retries")
        check(launches == rounds * per_round,
              f"{tag}: {launches} grant launches, want {rounds} x {per_round}")
        check(len(reports) == MAIN_R, f"{tag}: {len(reports)} reports")
        for r in reports:
            check(all(np.isfinite([r.violation_rate, r.realloc_frac,
                                   r.effective_frac, r.tiles_reserved_mean])),
                  "non-finite report field")
            check(0.0 <= r.violation_rate <= 1.0, "violation rate out of [0, 1]")
            check(sum(len(v) for v in r.chain_latencies.values()) > 0, "no latencies")
        loop = snap["phases"]["soa_loop"]
        out[tag] = dict(
            wall_s=wall, launches=launches, rounds=rounds, retries=retries,
            loop_s=loop["total_s"], loop_calls=loop["n"],
            rounds_per_s=rounds / loop["total_s"],
            phases={k: v["total_s"] for k, v in snap["phases"].items()},
            means=_means(reports),
        )
        last = reports
    # the scalar engine agrees on every structural fact of seed 0
    t = time.perf_counter()
    [ref] = run(dataclasses.replace(spec, seed=0), backend="scalar", device="cuda")
    check(soa.structural_invariants(ref) == soa.structural_invariants(last[0]),
          "main path: structural invariants differ from the scalar engine")
    emit("main", spec="commute ads_tile cockpit_replicas=4", R=MAIN_R,
         W=cfg.W, C=cfg.C, P=cfg.P, alloc_iters=cfg.alloc_iters,
         n_rounds=int(problem.const["t0"].shape[0]), scalar_seed0_s=time.perf_counter() - t,
         **out)
    return problem, out["warm"]["launches"]


def phase_loop():
    """CUDA loop vs CPU loop on identical inputs (R=4, 1 s of commute)."""
    res = {}
    for policy in ("cyc", "tp_driven", "ads_tile"):
        spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy)
        wf, model, sched, pf = runner._prepare_run(spec)
        prob = soa.build_problem(
            wf, model, sched, pf, runner._make_run_policy(spec, pf),
            spec.scenario, 1.0, n_lanes=4,
        )
        bt = sample_trace_batch(build_skeleton(wf, spec.scenario, 1.0), model,
                                spec.scenario, [0, 1, 2, 3])
        lanes = soa._lanes(prob, bt)
        a = K.simulate(prob.cfg, prob.const, lanes, device="cpu")
        b = K.simulate(prob.cfg, prob.const, lanes, device="cuda")
        same = (a["state"] == b["state"]) & (a["dop"] == b["dop"])
        both = same & np.isfinite(a["fin"]) & np.isfinite(b["fin"])
        fin_err = float(np.max(np.abs(a["fin"][both] - b["fin"][both]))) if both.any() else 0.0
        frac = float(1.0 - same.mean())
        res[policy] = dict(exact_state_dop=bool(same.all()), diff_frac=frac,
                           fin_max_abs_err=fin_err)
        check(frac <= 1e-3, f"loop {policy}: {frac:.2e} of state/dop entries differ")
        check(fin_err <= 1e-5, f"loop {policy}: fin error {fin_err}")
    emit("loop", **res)


def _device_kernels(prof):
    """(kernel count, busy microseconds as the union of the kernels'
    intervals, name -> (launches, total us)) of a torch.profiler run."""
    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kern:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + e.time_range.elapsed_us())
    return len(kern), busy, by_name


def _per_launch_ms(by_name, tag):
    hits = [v for k, v in by_name.items() if tag in k]
    n = sum(h[0] for h in hits)
    return (sum(h[1] for h in hits) / n / 1e3) if n else None


def phase_profile():
    """Device busy share of the round loop: torch.profiler over the first
    100 rounds of the main path's own problem (R=1024, same window)."""
    from torch.profiler import ProfilerActivity, profile

    spec = main_spec()
    prob = main_problem(spec, MAIN_R)
    n_rounds = 100
    const = dict(prob.const)
    for k in ("t0", "t1", "seg", "lo", "entry", "perm", "iperm"):
        const[k] = const[k][:n_rounds]
    wf, model, _s, _p = runner._prepare_run(spec)
    bt = sample_trace_batch(build_skeleton(wf, spec.scenario, prob.duration), model,
                            spec.scenario, list(range(MAIN_R)))
    lanes = soa._lanes(prob, bt)
    K.simulate(prob.cfg, const, lanes, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    K.simulate(prob.cfg, const, lanes, device="cuda")
    torch.cuda.synchronize()
    plain_us = 1e6 * (time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        K.simulate(prob.cfg, const, lanes, device="cuda")
        torch.cuda.synchronize()
        prof_us = 1e6 * (time.perf_counter() - t)
    n_kern, busy, by_name = _device_kernels(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    emit("profile", rounds=n_rounds, R=MAIN_R, W=prob.cfg.W,
         wall_ms=plain_us / 1e3, wall_ms_profiled=prof_us / 1e3,
         device_kernels=n_kern,
         kernels_per_round=n_kern / n_rounds if n_kern else None,
         device_busy_ms=busy / 1e3 if n_kern else None,
         device_idle_share=(1.0 - busy / plain_us) if n_kern else None,
         ladder_grant_device_ms=_per_launch_ms(by_name, "ladder_grant_kernel"),
         top_device_ms={k[:60]: [v[0], round(v[1] / 1e3, 3)] for k, v in top})


def _pooled(reports):
    return [x for r in reports for ls in r.chain_latencies.values() for x in ls]


def phase_equiv():
    res = {}
    seeds = [0, 1, 2, 3]
    for policy in ("cyc", "tp_driven", "ads_tile"):
        spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy)
        ref = [run(dataclasses.replace(spec, seed=s), backend="scalar", device="cuda")[0]
               for s in seeds]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = run(spec, seeds=seeds, backend="soa", fallback=False, device="cuda")
        for a, b in zip(ref, got):
            check(soa.structural_invariants(a) == soa.structural_invariants(b),
                  f"equiv {policy}: structural invariants")
        ks = soa.ks_statistic(_pooled(ref), _pooled(got))
        check(ks <= KS_TOL, f"equiv {policy}: KS {ks}")
        cis = {}
        for metric in ("violation_rate", "realloc_frac"):
            ca = soa.mean_ci([getattr(r, metric) for r in ref])
            cb = soa.mean_ci([getattr(r, metric) for r in got])
            check(soa.intervals_overlap(ca, cb, pad=1e-9), f"equiv {policy}: {metric} CI")
            cis[metric] = [ca, cb]
        res[policy] = dict(ks=ks, ci_scalar_vs_soa=cis)
    emit("equiv", scenario="commute", seeds=seeds, **res)


#: the reference launcher's traffic (src/repro/launch/serve.py): 12
#: requests, prompt 16, 16 new tokens, batch 4, max_len 128
SERVE = dict(arch="granite_moe_1b", requests=12, prompt_len=16, max_new=16,
             batch=4, max_len=128)
#: card (kernels) vs CPU (plain versions) on the same weights, held in
#: float32 on both sides (the bf16 weights widened exactly): max |logit
#: difference| over one prefill and 4 decode steps.  The two sides sum in
#: other orders (~1e-6 relative per product), which 24 layers grow to
#: ~1e-4 on logits of magnitude ~5.  In bf16 the same comparison is not
#: stable: a rounding difference can flip one of a token's top-8 experts,
#: which moves the logits by O(1)
XCHECK_STEPS = 4
XCHECK_LOGIT_ATOL = 2e-3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zero_counts():
    K.ladder_grant.launches = 0
    FA.flash_attention.launches = 0
    MG.moe_gmm.launches = 0


def _counts():
    return {"ladder_grant": K.ladder_grant.launches,
            "flash_attention": FA.flash_attention.launches,
            "moe_gmm": MG.moe_gmm.launches}


def _greedy_steps(model, params, prompt, steps, device, feed=None):
    """Prefill ``prompt`` at batch 1, then ``steps`` decode steps; each
    step feeds ``feed[i]`` (teacher forcing) or the last greedy token.
    Returns float32 logits per step and the greedy tokens."""
    cache = model.init_cache(1, SERVE["max_len"], device)
    toks = torch.as_tensor(prompt[None].astype(np.int64), device=device)
    out, greedy = [], []
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": toks}, cache)
        for i in range(steps + 1):
            if i:
                nxt = feed[i - 1] if feed is not None else greedy[-1]
                t = torch.tensor([[nxt]], dtype=torch.int64, device=device)
                lg, cache = model.decode_step(params, {"tokens": t}, cache,
                                              len(prompt) + i - 1)
            out.append(lg[0].float().cpu())
            greedy.append(int(torch.argmax(lg[0])))
    return out, greedy


def _serve_xcheck(cfg, params, prompt):
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = LM(cfg32)
    p32 = _to(params, "cuda", torch.float32)
    t = time.perf_counter()
    gpu_logits, gpu_tok = _greedy_steps(model, p32, prompt, XCHECK_STEPS, "cuda")
    gpu_s = time.perf_counter() - t
    p32 = _to(p32, "cpu")
    t = time.perf_counter()
    cpu_logits, cpu_tok = _greedy_steps(model, p32, prompt, XCHECK_STEPS, "cpu",
                                        feed=gpu_tok[:-1])
    cpu_s = time.perf_counter() - t
    errs, margins = [], []
    for a, b in zip(gpu_logits, cpu_logits):
        check(bool(torch.isfinite(a).all()), "serve xcheck: non-finite card logits")
        errs.append(float((a - b).abs().max()))
        top2 = torch.topk(b, 2).values
        margins.append(float(top2[0] - top2[1]))
    res = dict(dtype="float32", steps=1 + XCHECK_STEPS, tokens=gpu_tok,
               max_abs_logit_err=errs, cpu_top2_margin=margins,
               logit_atol=XCHECK_LOGIT_ATOL, card_s=gpu_s, cpu_s=cpu_s)
    emit("serve_xcheck", **res)
    check(max(errs) <= XCHECK_LOGIT_ATOL,
          f"serve xcheck: card vs CPU logits differ by {max(errs)} > {XCHECK_LOGIT_ATOL}")
    check(gpu_tok == cpu_tok, f"serve xcheck: greedy tokens differ: card {gpu_tok}, "
          f"CPU {cpu_tok} (CPU top-2 margins {margins})")
    return res


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or tree.dtype)


def _serve_profile(cfg, params, ecfg, n_steps=3):
    """Device busy share of the decode step at a full batch: ``n_steps``
    engine iterations timed plain, then ``n_steps`` more under
    torch.profiler (the idle share is taken against the plain time)."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServingEngine(cfg, params, ecfg, device="cuda")
    rng = np.random.RandomState(1)
    for i in range(ecfg.max_batch):
        eng.submit(Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, (SERVE["prompt_len"],))
                           .astype(np.int32), max_new_tokens=SERVE["max_new"]))
    eng.step()   # prefills and the first decode step
    eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    plain_us = 1e6 * (time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        prof_us = 1e6 * (time.perf_counter() - t)
    n_kern, busy, by_name = _device_kernels(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        decode_steps=n_steps, batch=ecfg.max_batch,
        wall_ms_per_step=plain_us / 1e3 / n_steps,
        wall_ms_per_step_profiled=prof_us / 1e3 / n_steps,
        device_kernels_per_step=n_kern / n_steps,
        device_busy_ms_per_step=busy / 1e3 / n_steps if n_kern else None,
        device_idle_share=(1.0 - busy / plain_us) if n_kern else None,
        flash_attention_device_ms=_per_launch_ms(by_name, "flash_fwd_kernel"),
        moe_gmm_device_ms=_per_launch_ms(by_name, "moe_gmm_kernel"),
        top_device_ms={k[:60]: [v[0], round(v[1] / 1e3, 4)] for k, v in top},
    )


def phase_serve():
    cfg = get_config(SERVE["arch"])
    t = time.perf_counter()
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weight_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    ecfg = EngineConfig(max_batch=SERVE["batch"], max_len=SERVE["max_len"])

    # warm-up request (cuBLAS handles, kernel libraries) on its own engine
    warm = ServingEngine(cfg, params, ecfg, device="cuda")
    warm.submit(Request(rid=-1, prompt=np.zeros(SERVE["prompt_len"], np.int32),
                        max_new_tokens=2))
    warm.run_until_drained()
    del warm

    engine = ServingEngine(cfg, params, ecfg, device="cuda")
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, (SERVE["prompt_len"],))
                    .astype(np.int32), max_new_tokens=SERVE["max_new"])
            for i in range(SERVE["requests"])]
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    for r in reqs:
        r.arrival_s = time.time()
        engine.submit(r)
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts()

    calls = engine.prefill_calls + engine.decode_calls
    for name in ("flash_attention", "moe_gmm"):
        check(launches[name] == cfg.num_layers * calls,
              f"serve: {launches[name]} {name} launches, want {cfg.num_layers} x {calls}")
    toks = [t for r in reqs for t in r.generated]
    check(all(len(r.generated) == SERVE["max_new"] for r in reqs), "serve: short request")
    check(all(0 <= t < cfg.vocab_size for t in toks), "serve: token outside [0, vocab)")
    lat = np.array([r.finish_s - r.arrival_s for r in reqs])
    ftl = np.array([r.first_token_s - r.arrival_s for r in reqs])
    emit("serve", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
         params=int(sum(p.numel() for p in _leaves(params))), weight_bytes=int(weight_bytes),
         init_s=init_s, traffic=SERVE, wall_s=wall, tokens=len(toks),
         tokens_per_s=len(toks) / wall,
         latency_p50_s=float(np.percentile(lat, 50)), latency_p99_s=float(np.percentile(lat, 99)),
         first_token_p50_s=float(np.percentile(ftl, 50)),
         first_token_p99_s=float(np.percentile(ftl, 99)),
         prefill_calls=engine.prefill_calls, decode_calls=engine.decode_calls,
         launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    prof = _serve_profile(cfg, params, ecfg)
    emit("serve_profile", **prof)
    _serve_xcheck(cfg, params, reqs[0].prompt)
    return dict(params=params, launches=launches, profile=prof)


def _bound(nbytes, nops, ops_per_s):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ladder_timing(problem, launches, errs):
    cfg = problem.cfg
    R, W, C = MAIN_R, cfg.W, cfg.C
    # a real ladder of the main path: segment 0's candidate rows
    ladder = torch.from_numpy(np.ascontiguousarray(problem.const["cands"][0, :W]))
    limit, cand = ladder_inputs(R, W, C, "shared", seed=7, ladder=ladder)
    got, want = K.ladder_grant(limit, cand), K._ladder_grant(limit, cand)
    torch.cuda.synchronize()
    errs["ladder_grant"].append(float((got - want).abs().max()))
    check(torch.equal(got, want), "ladder_grant at the main path's shape")
    ms = cuda_ms(lambda: K.ladder_grant(limit, cand))
    plain_ms = cuda_ms(lambda: K._ladder_grant(limit, cand))
    ms2 = cuda_ms(lambda: K.ladder_grant(limit, cand))
    nbytes = 4 * R * W + 4 * W * C + 4 * R * W        # limit, ladder in; grant out
    nops = 3 * R * W * C                              # add+compare, select, max
    bound_ms, by = _bound(nbytes, nops, F32_OPS_PER_S)
    emit("timing", name="ladder_grant", R=R, W=W, C=C, ms_runs=[ms, ms2],
         plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes, ops=nops)
    return {"name": "ladder_grant", "route": "cuda",
            "source": "src/repro_torch/csrc/ladder_grant.cu",
            "replaces": "src/repro/core/sim/soa_kernels.py:178",
            "launches": int(launches), "max_abs_err": max(errs["ladder_grant"]),
            "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def _sdpa(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call with
    the same mask (GQA through ``enable_gqa``)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def _flash_timing(launches, errs):
    out = {}
    for name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, c in FLASH_CASES[:2]:
        dt = torch.bfloat16
        q, k, v = flash_inputs(B, Hq, Hkv, Lq, Lk, D, dt, seed=900)
        kw = dict(causal=True, window=w, softcap=c, q_offset=qo, kv_valid_len=kvl)
        got = FA.flash_attention(q, k, v, **kw)
        errs["flash_attention"].append(_held(got, FA.flash_attention_plain(q, k, v, **kw), dt,
                                             f"flash_attention timing {name}"))
        qpos = qo + torch.arange(Lq, device="cuda")[:, None]
        kpos = torch.arange(Lk, device="cuda")[None, :]
        mask = (kpos < kvl) & (kpos <= qpos)
        lib = _sdpa(q, k, v, mask)
        _held(got, lib, dt, f"flash_attention {name} vs scaled_dot_product_attention")
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw))
        lib_ms = cuda_ms(lambda: _sdpa(q, k, v, mask))
        ms2 = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw))
        pairs = int(mask.sum()) * B * Hq                 # visible (query, key) pairs
        nbytes = 2 * (2 * B * Hq * Lq * D + 2 * B * Hkv * kvl * D)   # q, out; valid k, v rows
        nops = 4 * pairs * D                             # q.k and p.v
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         bytes=nbytes, ops=nops)
        emit("timing", name="flash_attention", case=name, dtype="bfloat16",
             q=[B, Hq, Lq, D], kv=[B, Hkv, Lk, D], q_offset=qo, kv_valid_len=kvl, **out[name])
    d = out["serve_decode"]   # the call the serve path makes most
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:88",
            "launches": int(launches), "max_abs_err": max(errs["flash_attention"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"]}


def _moe_timing(params, launches, errs):
    """At the serve shape, on the model's own expert weights, one layer
    after another (2.4 GB in all, so every call finds its weights cold in
    L2, as the serve path does)."""
    name, E, C, D, Fd, _ = MOE_CASES[0]
    dt = torch.bfloat16
    moe = params["layers"]["moe"]
    L = moe["wg"].shape[0]
    x = _randn((E, C, D), dt, seed=901)
    got = MG.moe_gmm(x, moe["wg"][0], moe["wu"][0], moe["wd"][0])
    errs["moe_gmm"].append(_held(got, MG.moe_gmm_plain(x, moe["wg"][0], moe["wu"][0],
                                                       moe["wd"][0]), dt, "moe_gmm timing"))
    it = {"i": 0}

    def cycle(fn):
        def call():
            i = it["i"] = (it["i"] + 1) % L
            return fn(x, moe["wg"][i], moe["wu"][i], moe["wd"][i])
        return call

    ms = cuda_ms(cycle(MG.moe_gmm), iters=240, warmup=24)
    plain_ms = cuda_ms(cycle(MG.moe_gmm_plain), iters=48, warmup=24)
    ms2 = cuda_ms(cycle(MG.moe_gmm), iters=240, warmup=24)
    nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)    # x, out; wg, wu, wd
    nops = 2 * E * C * D * Fd * 3
    bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
    emit("timing", name="moe_gmm", case=name, dtype="bfloat16", x=[E, C, D], F=Fd,
         ms_runs=[ms, ms2], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
         bytes=nbytes, ops=nops, library_ms=None)
    return {"name": "moe_gmm", "route": "cuda", "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:35",
            "launches": int(launches), "max_abs_err": max(errs["moe_gmm"]),
            "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def phase_timing(problem, ladder_launches, serve, errs):
    kernels = []
    if problem is not None:
        kernels.append(_ladder_timing(problem, ladder_launches, errs))
    if serve is not None:
        kernels.append(_flash_timing(serve["launches"]["flash_attention"], errs))
        kernels.append(_moe_timing(serve["params"], serve["launches"]["moe_gmm"], errs))
    print(json.dumps({"kernels": kernels}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    only = set(ap.parse_args().only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = phase_device()
    errs = {k: [] for k in KERNELS}
    if "build" in only:
        phase_build()
    if "kernel" in only:
        phase_kernel(errs)
    if "sampler" in only:
        phase_sampler()
    problem, launches = (None, 0)
    if "main" in only:
        problem, launches = phase_main()
    if "loop" in only:
        phase_loop()
    if "equiv" in only:
        phase_equiv()
    if "profile" in only:
        phase_profile()
    serve = phase_serve() if "serve" in only else None
    if "timing" in only:
        phase_timing(problem, launches, serve, errs)
    emit("done", seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
