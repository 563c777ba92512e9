#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py                 # every phase (the full check)
    python3 chip_smoke.py --only device,build,kernel   # a short first call

Phases, each printing one JSON line:

1. ``device``  — the card (and, on its own line, ``nvidia-smi``'s name and
   power limit);
2. ``build``   — builds every CUDA kernel of the port from ``src/``, all
   ``nvcc`` processes started together;
3. ``kernel``  — each kernel against its plain PyTorch version on the card
   at the main path's widths (exact equality for the ladder grant);
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
9. ``timing``  — kernel, plain-version and bound times at the main path's
   shape, then the ``kernels`` line.

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
from repro_torch.core.sim import soa  # noqa: E402
from repro_torch.core.sim import soa_kernels as K  # noqa: E402
from repro_torch.core.sim.batch import sample_trace_batch  # noqa: E402
from repro_torch.core.sim.trace import build_skeleton  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.scenarios import ScenarioSpec, get_scenario, run  # noqa: E402
from repro_torch.scenarios import runner  # noqa: E402

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor fp32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

PHASES = ("device", "build", "kernel", "sampler", "main", "loop", "equiv",
          "profile", "timing")
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
    libs = _cuda.build(["ladder_grant"])
    emit("build", seconds=time.perf_counter() - t,
         libs={k: os.path.basename(str(v)) for k, v in libs.items()},
         ptxas={k: v.strip().splitlines()[-4:] for k, v in _cuda.BUILD_LOG.items()})


def phase_kernel(errs):
    for W in (96, 144):
        for layout in ("shared", "per_lane"):
            limit, cand = ladder_inputs(MAIN_R, W, 6, layout, seed=W)
            got = K.ladder_grant(limit, cand)
            want = K._ladder_grant(limit, cand)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs.append(err)
            check(torch.equal(got, want), f"ladder_grant W={W} {layout}: max err {err}")
            ref = K.ladder_grant_reference(limit.cpu().numpy(), cand.cpu().numpy())
            check(np.array_equal(got.cpu().numpy(), ref), "ladder_grant vs NumPy oracle")
    emit("kernel", name="ladder_grant", shapes="R=1024 W=96,144 C=6, (W,C) and (R,W,C)",
         exact=True, max_abs_err=max(errs))


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
    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kern:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    grant = [v for k, v in by_name.items() if "ladder_grant_kernel" in k]
    emit("profile", rounds=n_rounds, R=MAIN_R, W=prob.cfg.W,
         wall_ms=plain_us / 1e3, wall_ms_profiled=prof_us / 1e3,
         device_kernels=len(kern),
         kernels_per_round=len(kern) / n_rounds if kern else None,
         device_busy_ms=busy / 1e3 if kern else None,
         device_idle_share=(1.0 - busy / plain_us) if kern else None,
         ladder_grant_device_ms=(grant[0][1] / grant[0][0] / 1e3) if grant else None,
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


def phase_timing(problem, launches, errs):
    cfg = problem.cfg
    R, W, C = MAIN_R, cfg.W, cfg.C
    # a real ladder of the main path: segment 0's candidate rows
    ladder = torch.from_numpy(np.ascontiguousarray(problem.const["cands"][0, :W]))
    limit, cand = ladder_inputs(R, W, C, "shared", seed=7, ladder=ladder)
    got, want = K.ladder_grant(limit, cand), K._ladder_grant(limit, cand)
    torch.cuda.synchronize()
    errs.append(float((got - want).abs().max()))
    check(torch.equal(got, want), "ladder_grant at the main path's shape")
    ms = cuda_ms(lambda: K.ladder_grant(limit, cand))
    plain_ms = cuda_ms(lambda: K._ladder_grant(limit, cand))
    ms2 = cuda_ms(lambda: K.ladder_grant(limit, cand))
    nbytes = 4 * R * W + 4 * W * C + 4 * R * W        # limit, ladder in; grant out
    nops = 3 * R * W * C                              # add+compare, select, max
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    emit("timing", name="ladder_grant", R=R, W=W, C=C, ms_runs=[ms, ms2],
         plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes, ops=nops)
    print(json.dumps({"kernels": [{
        "name": "ladder_grant",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ladder_grant.cu",
        "replaces": "src/repro/core/sim/soa_kernels.py:178",
        "launches": int(launches),
        "max_abs_err": max(errs),
        "ms": min(ms, ms2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    only = set(ap.parse_args().only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = phase_device()
    errs = []
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
    if "timing" in only and problem is not None:
        phase_timing(problem, launches, errs)
    emit("done", seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
