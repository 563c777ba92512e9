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
   decode cases, in bf16 and f32 (tolerances ``TOL``); the SSD intra-chunk
   kernel at the sweep shapes, mamba2-2.7b's full width (L = 1024 and a
   ragged L = 600) and the serve prefill, and ``ops.ssd_chunked`` against
   the model-level chunked scan with a nonzero initial state (``TOL_SSD``);
   the RG-LRU scan at the sweep shapes, recurrentgemma's prefill
   ``(1, 2048, 4096)`` and decode ``(4, 1, 4096)``; flash attention at
   D = 256 on 128-slot rings (part-filled and wrapped ``kv_positions``);
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
9. ``serve``   — the LM serving path, for each arch of ``SERVE_ARCHS`` in
   turn (each freed before the next is built): ``ServingEngine`` at full
   width in bf16 (random weights from seed 0) with the reference
   launcher's traffic (12 requests, prompt 16, 16 new tokens, batch 4,
   max_len 128), every launch counter set to 0 just before and read just
   after, and each kernel's count asserted; tokens/s, request and
   first-token latency, weight bytes; a profiled window of decode steps
   (``serve_profile``); one request's prefill and 4 decode steps held
   against the port's CPU path on the same weights, widened to float32 on
   both sides (``serve_xcheck``; ``XCHECK_LAYERS`` cuts the depth where
   the float32 copy would not fit the host);
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
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.models import LM, init_params  # noqa: E402
from repro_torch.models.lm import _hybrid_layout as hybrid_layout  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked as ssd_chunked_plain  # noqa: E402
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
KERNELS = ("ladder_grant", "flash_attention", "moe_gmm", "ssd_intra_chunk", "rglru_scan")
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
#: the SSD kernel's tolerances there (``test_ssd_kernel_sweep``): its outputs
#: are float32 sums of up to 256 terms of magnitude ~10
TOL_SSD = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
#: the kernel (and ops.ssd_chunked) against the formulations that form the
#: prefix sum acum in float32 (the reference-copied oracle, the model-level
#: chunked scan), at chunk 256: |acum| reaches ~300, where a float32 ulp is
#: 3e-5, so their exponents differ by rounding alone and y by up to 1.7e-3
#: against a float64 evaluation of the same inputs (measured on the CPU at
#: this shape; see kernels/ssd.py).  Chunks of 16 and 32 keep ``TOL_SSD``
TOL_SSD_F32_ACUM = {torch.float32: dict(rtol=2e-3, atol=2e-3),
                    torch.bfloat16: TOL_SSD[torch.bfloat16]}
DTYPES = (torch.bfloat16, torch.float32)


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _held(got, want, dtype, what, tol=TOL):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **tol[dtype]), f"{what}: max abs err {err}")
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


#: (name, B, L, H, P, N, chunk): tests/test_kernels.py's SSD sweep,
#: mamba2-2.7b's full width (80 heads of 64, state 128, chunk 256) at
#: L = 1024 and a ragged L = 600, and the serve prefill (one chunk of 16)
SSD_CASES = [
    ("sweep_1x64x4x16x16", 1, 64, 4, 16, 16, 16),
    ("sweep_2x96x8x32x32", 2, 96, 8, 32, 32, 32),
    ("full_L1024", 1, 1024, 80, 64, 128, 256),
    ("full_ragged_L600", 1, 600, 80, 64, 128, 256),
    ("serve_prefill", 1, 16, 80, 64, 128, 16),
]


def ssd_inputs(B, L, H, P, N, dtype, seed):
    """x, dt (softplus'd), A (< 0), Bm, Cm as the model makes them: x/B/C in
    ``dtype``, dt and A float32; B/C with one group (B, L, 1, N)."""
    x = _randn((B, L, H, P), dtype, seed)
    dt = torch.nn.functional.softplus(_randn((B, L, H), torch.float32, seed + 1))
    A = -torch.exp(_randn((H,), torch.float32, seed + 2, 0.3))
    return x, dt, A, _randn((B, L, 1, N), dtype, seed + 3), _randn((B, L, 1, N), dtype, seed + 4)


def ssd_chunks(x, dt, Bm, Cm, chunk):
    """The chunk-major layout ``ops.ssd_chunked`` hands the kernel (the
    ragged tail padded with dt = 0)."""
    B, L, H, P = x.shape
    c = min(chunk, L)
    nb = -(-L // c)
    pad = nb * c - L
    F = torch.nn.functional
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    Bm, Cm = F.pad(Bm, (0, 0, 0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, 0, 0, pad))
    N = Bm.shape[-1]
    return (x.reshape(B, nb, c, H, P), dt.reshape(B, nb, c, H),
            Bm.reshape(B, nb, c, N), Cm.reshape(B, nb, c, N))


#: (name, B, L, W): tests/test_kernels.py's RG-LRU sweep, recurrentgemma-9b's
#: LRU width at a 2048-token prefill and at the batch-4 decode step
RGLRU_CASES = [("sweep_1x64x64", 1, 64, 64), ("sweep_2x48x128", 2, 48, 128),
               ("prefill_1x2048x4096", 1, 2048, 4096), ("decode_4x1x4096", 4, 1, 4096)]

#: (name, B, Hq, Hkv, W slots, D, pos, window): recurrentgemma's decode on
#: its 128-slot ring (16 query heads on one KV head of 256), part-filled
#: (empty slots at negative positions) and wrapped; and a window inside the
#: ring at a smaller head dim
RING_CASES = [("ring_part_filled_d256", 4, 16, 1, 128, 256, 40, 2048),
              ("ring_wrapped_d256", 4, 16, 1, 128, 256, 300, 2048),
              ("ring_wrapped_window_d64", 2, 8, 2, 64, 64, 150, 48)]


def ring_positions(pos, slots):
    """Slot i of a ring that holds position p in slot p mod W sits at
    position pos - ((pos - i) mod W): negative for a slot not yet written."""
    idx = torch.arange(slots, dtype=torch.int32, device="cuda")
    return pos - torch.remainder(pos - idx, slots)


def rglru_inputs(B, L, W, dtype, seed):
    return (_randn((B, L, W), dtype, seed), _randn((B, L, W), dtype, seed + 1),
            _randn((B, L, W), dtype, seed + 2), _randn((W,), torch.float32, seed + 3),
            _randn((B, W), dtype, seed + 4))


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
    for i, (name, B, Hq, Hkv, W, D, pos, w) in enumerate(RING_CASES):
        for dtype in DTYPES:
            q, k, v = flash_inputs(B, Hq, Hkv, 1, W, D, dtype, seed=300 + 10 * i)
            kw = dict(causal=True, window=w, q_offset=pos, kv_positions=ring_positions(pos, W))
            before = FA.flash_attention.launches
            got = FA.flash_attention(q, k, v, **kw)
            check(FA.flash_attention.launches == before + 1, f"flash {name}: no launch")
            err = _held(got, FA.flash_attention_plain(q, k, v, **kw), dtype,
                        f"flash_attention {name} {dtype}")
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

    res = {}
    for i, (name, B, L, H, P, N, chunk) in enumerate(SSD_CASES):
        for dtype in DTYPES:
            x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, dtype, seed=700 + 10 * i)
            xc, dtc, Bc, Cc = ssd_chunks(x, dt, Bm, Cm, chunk)
            before = SSD.ssd_intra_chunk.launches
            got = SSD.ssd_intra_chunk(xc, dtc, A, Bc, Cc)
            check(SSD.ssd_intra_chunk.launches == before + 1, f"ssd {name}: no launch")
            want = SSD.ssd_intra_chunk_plain(xc, dtc, A, Bc, Cc)
            err = max(_held(g, w, dtype, f"ssd_intra_chunk {name} {dtype} {part}", TOL_SSD)
                      for g, w, part in zip(got, want, ("y_intra", "contrib", "chunk_decay")))
            tol = TOL_SSD_F32_ACUM if chunk > 32 else TOL_SSD
            ora = kref.ssd_intra_chunk_ref(xc, dtc, A, Bc, Cc)
            for g, w, part in zip(got, ora, ("y_intra", "contrib", "chunk_decay")):
                _held(g, w, dtype, f"ssd_intra_chunk {name} {dtype} {part} vs ref", tol)
            # the whole op, seeded with a nonzero state, against the
            # model-level chunked scan (an independent formulation)
            s0 = _randn((B, H, P, N), torch.float32, seed=790 + i, scale=0.1)
            y, fin = kops.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
            y2, fin2 = ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
            check(tuple(y.shape) == (B, L, H, P) and y.dtype == dtype, f"ssd_chunked {name}")
            _held(y, y2, dtype, f"ssd_chunked {name} {dtype} y", tol)
            _held(fin, fin2, dtype, f"ssd_chunked {name} {dtype} state", tol)
            errs["ssd_intra_chunk"].append(err)
            res[f"{name}/{str(dtype)[6:]}"] = err
    emit("kernel", name="ssd_intra_chunk", cases=len(res),
         tol={str(k)[6:]: v for k, v in TOL_SSD.items()},
         max_abs_err=max(errs["ssd_intra_chunk"]), max_abs_err_by_case=res)

    res = {}
    for i, (name, B, L, W) in enumerate(RGLRU_CASES):
        for dtype in DTYPES:
            args = rglru_inputs(B, L, W, dtype, seed=400 + 10 * i)
            before = RG.rglru_scan.launches
            got = RG.rglru_scan(*args)
            check(RG.rglru_scan.launches == before + 1, f"rglru {name}: no launch")
            err = max(_held(g, w, dtype, f"rglru_scan {name} {dtype} {part}")
                      for g, w, part in zip(got, RG.rglru_scan_plain(*args), ("h", "h_T")))
            for g, w, part in zip(got, kref.rglru_scan_ref(*args), ("h", "h_T")):
                _held(g, w, dtype, f"rglru_scan {name} {dtype} {part} vs ref")
            errs["rglru_scan"].append(err)
            res[f"{name}/{str(dtype)[6:]}"] = err
    emit("kernel", name="rglru_scan", cases=len(res), tol={str(k)[6:]: v for k, v in TOL.items()},
         max_abs_err=max(errs["rglru_scan"]), max_abs_err_by_case=res)


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


#: the archs the serve phase drives, in turn, at full width
SERVE_ARCHS = ("granite_moe_1b", "mamba2_2p7b", "recurrentgemma_9b")
#: the reference launcher's traffic (src/repro/launch/serve.py): 12
#: requests, prompt 16, 16 new tokens, batch 4, max_len 128
SERVE = dict(requests=12, prompt_len=16, max_new=16, batch=4, max_len=128)
#: card (kernels) vs CPU (plain versions) on the same weights, held in
#: float32 on both sides (the bf16 weights widened exactly): max |logit
#: difference| over one prefill and 4 decode steps.  The two sides sum in
#: other orders (~1e-6 relative per product), which 24-64 layers grow to
#: ~1e-4 on logits of magnitude ~5.  In bf16 the same comparison is not
#: stable: a rounding difference can flip one of a token's top-8 experts,
#: which moves the logits by O(1)
XCHECK_STEPS = 4
XCHECK_LOGIT_ATOL = 2e-3
#: depth of the float32 cross-check per arch (absent: the full depth).
#: recurrentgemma-9b's 9.4 B parameters are 37.6 GB in float32, which with
#: the host's own copy would not fit: it is checked at full width on one
#: (lru, lru, attn) unit and the two trailing LRU blocks
XCHECK_LAYERS = {"recurrentgemma-9b": 5}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


#: the launch-counted wrapper of each kernel
COUNTED = {"ladder_grant": K.ladder_grant, "flash_attention": FA.flash_attention,
           "moe_gmm": MG.moe_gmm, "ssd_intra_chunk": SSD.ssd_intra_chunk,
           "rglru_scan": RG.rglru_scan}


def _zero_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def _expected_launches(cfg, prefill_calls, decode_calls):
    """Kernel launches one serve run must make: one per layer that runs
    the kernel per engine call (SSD only in prefills), none elsewhere."""
    want = dict.fromkeys(COUNTED, 0)
    calls = prefill_calls + decode_calls
    if cfg.family == "ssm":
        want["ssd_intra_chunk"] = cfg.num_layers * prefill_calls
    elif cfg.family == "hybrid":
        n_lru, n_att = hybrid_layout(cfg)
        want["rglru_scan"] = n_lru * calls
        want["flash_attention"] = n_att * calls
    else:
        want["flash_attention"] = cfg.num_layers * calls
        if cfg.num_experts:
            want["moe_gmm"] = cfg.num_layers * calls
    return want


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


def _cut_depth(cfg, params, layers):
    """The first ``layers`` layers of a stacked tree (for the hybrid, the
    LRU and attention stacks its shorter pattern needs)."""
    cut = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family == "hybrid":
        n_lru, n_att = hybrid_layout(cut)
        stacks = {"lru_layers": n_lru, "attn_layers": n_att}
    else:
        stacks = {"layers": layers}
    out = dict(params)
    for key, n in stacks.items():
        out[key] = _map(params[key], lambda a, n=n: a[:n])
    return cut, out


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _serve_xcheck(cfg, params, prompt):
    layers = XCHECK_LAYERS.get(cfg.name)
    if layers:
        cfg, params = _cut_depth(cfg, params, layers)
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
    del p32
    res = dict(arch=cfg.name, layers=cfg.num_layers, dtype="float32",
               steps=1 + XCHECK_STEPS, tokens=gpu_tok,
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


#: kernel -> a substring of its device kernel's name (for the SSD wrapper,
#: the chunk kernel that follows its C.B^T tiles)
DEVICE_NAMES = {"flash_attention": "flash_fwd_kernel", "moe_gmm": "moe_gmm_kernel",
                "ssd_intra_chunk": "ssd_chunk_kernel", "rglru_scan": "rglru_scan_kernel"}


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
        arch=cfg.name, decode_steps=n_steps, batch=ecfg.max_batch,
        wall_ms_per_step=plain_us / 1e3 / n_steps,
        wall_ms_per_step_profiled=prof_us / 1e3 / n_steps,
        device_kernels_per_step=n_kern / n_steps,
        device_busy_ms_per_step=busy / 1e3 / n_steps if n_kern else None,
        device_idle_share=(1.0 - busy / plain_us) if n_kern else None,
        kernel_device_ms={name: _per_launch_ms(by_name, tag) for name, tag in DEVICE_NAMES.items()},
        top_device_ms={k[:60]: [v[0], round(v[1] / 1e3, 4)] for k, v in top},
    )


def phase_serve(arch):
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
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

    want = _expected_launches(cfg, engine.prefill_calls, engine.decode_calls)
    check(launches == want, f"serve {arch}: launches {launches}, want {want}")
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
    # the timing phase reuses granite-moe's expert weights (2.4 GB); the
    # rest of every model is freed before the next one is built
    return dict(launches=launches, profile=prof,
                moe=params["layers"]["moe"] if cfg.num_experts else None)


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
    """granite-moe's decode and prefill (D = 64) and recurrentgemma's ring
    decode and prefill (D = 256, MQA); granite's decode is the
    kernels-line row (the call the serve path makes most)."""
    out = {}
    cases = [(c, None) for c in FLASH_CASES[:2]] + [
        (("rg_decode_d256", 4, 16, 1, 1, 128, 256, 24, 128, 2048, 0.0), 24),
        (("rg_prefill_d256", 1, 16, 1, 16, 16, 256, 0, 16, 2048, 0.0), None),
    ]
    for (name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, c), ring_pos in cases:
        dt = torch.bfloat16
        q, k, v = flash_inputs(B, Hq, Hkv, Lq, Lk, D, dt, seed=900)
        kw = dict(causal=True, window=w, softcap=c, q_offset=qo, kv_valid_len=kvl)
        qpos = qo + torch.arange(Lq, device="cuda")[:, None]
        if ring_pos is None:
            kpos = torch.arange(Lk, device="cuda")[None, :]
            mask = (kpos < kvl) & (kpos <= qpos)
        else:
            kw = dict(causal=True, window=w, softcap=c, q_offset=qo,
                      kv_positions=ring_positions(ring_pos, Lk))
            kpos = kw["kv_positions"][None, :]
            mask = (kpos >= 0) & (kpos <= qpos)
        if w > 0:
            mask = mask & (kpos > qpos - w)
        got = FA.flash_attention(q, k, v, **kw)
        errs["flash_attention"].append(_held(got, FA.flash_attention_plain(q, k, v, **kw), dt,
                                             f"flash_attention timing {name}"))
        lib = _sdpa(q, k, v, mask)
        _held(got, lib, dt, f"flash_attention {name} vs scaled_dot_product_attention")
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw))
        lib_ms = cuda_ms(lambda: _sdpa(q, k, v, mask))
        ms2 = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw))
        pairs = int(mask.sum()) * B * Hq                 # visible (query, key) pairs
        rows = int(mask.any(dim=0).sum())                # key rows any query sees
        nbytes = 2 * (2 * B * Hq * Lq * D + 2 * B * Hkv * rows * D)  # q, out; visible k, v
        nops = 4 * pairs * D                             # q.k and p.v
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         bytes=nbytes, ops=nops)
        emit("timing", name="flash_attention", case=name, dtype="bfloat16",
             q=[B, Hq, Lq, D], kv=[B, Hkv, Lk, D], q_offset=qo, kv_valid_len=kvl,
             ring_pos=ring_pos, **out[name])
    d = out["serve_decode"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:88",
            "launches": int(launches), "max_abs_err": max(errs["flash_attention"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "d256_decode": out["rg_decode_d256"], "d256_prefill": out["rg_prefill_d256"]}


def _moe_timing(moe, launches, errs):
    """At the serve shape, on the model's own expert weights, one layer
    after another (2.4 GB in all, so every call finds its weights cold in
    L2, as the serve path does)."""
    name, E, C, D, Fd, _ = MOE_CASES[0]
    dt = torch.bfloat16
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


def _ssd_timing(launches, errs):
    """At mamba2-2.7b's full width, L = 1024 (4 chunks of 256), and at the
    serve prefill (one chunk of 16); the first is the kernels-line row."""
    out = {}
    for name, B, L, H, P, N, chunk in (SSD_CASES[2], SSD_CASES[4]):
        dt_ = torch.bfloat16
        x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, dt_, seed=902)
        xc, dtc, Bc, Cc = ssd_chunks(x, dt, Bm, Cm, chunk)
        args = (xc, dtc, A, Bc, Cc)
        got = SSD.ssd_intra_chunk(*args)
        errs["ssd_intra_chunk"].append(max(
            _held(g, w, dt_, f"ssd_intra_chunk timing {name}", TOL_SSD)
            for g, w in zip(got, SSD.ssd_intra_chunk_plain(*args))))
        ms = cuda_ms(lambda: SSD.ssd_intra_chunk(*args), iters=100, warmup=10)
        plain_ms = cuda_ms(lambda: SSD.ssd_intra_chunk_plain(*args), iters=10, warmup=3)
        ms2 = cuda_ms(lambda: SSD.ssd_intra_chunk(*args), iters=100, warmup=10)
        _, nb, C, _, _ = xc.shape
        BC = B * nb
        tri = C * (C + 1) // 2                          # (t, s <= t) pairs per chunk
        nbytes = (2 * B * L * H * P + 4 * B * L * H + 4 * H + 2 * 2 * B * L * N   # x, dt, A, B, C
                  + 4 * BC * C * H * P + 4 * BC * H * P * N + 4 * BC * H)      # y, contrib, decay
        nops = BC * tri * N * 2 + BC * H * (tri * P * 2 + C * P * N * 2)       # C.B^T, y, contrib
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops)
        emit("timing", name="ssd_intra_chunk", case=name, dtype="bfloat16",
             x=list(xc.shape), N=N, library_ms=None, **out[name])
    d = out["full_L1024"]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd.py:65",
            "launches": int(launches), "max_abs_err": max(errs["ssd_intra_chunk"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None}


def _rglru_timing(launches, errs):
    """At recurrentgemma-9b's LRU width: a 2048-token prefill (the
    kernels-line row) and the batch-4 decode step."""
    out = {}
    for name, B, L, W in RGLRU_CASES[2:]:
        dt_ = torch.bfloat16
        args = rglru_inputs(B, L, W, dt_, seed=903)
        got = RG.rglru_scan(*args)
        errs["rglru_scan"].append(max(_held(g, w, dt_, f"rglru_scan timing {name}")
                                      for g, w in zip(got, RG.rglru_scan_plain(*args))))
        ms = cuda_ms(lambda: RG.rglru_scan(*args), iters=100, warmup=10)
        plain_ms = cuda_ms(lambda: RG.rglru_scan_plain(*args), iters=3 if L > 1 else 100,
                           warmup=1 if L > 1 else 10)
        ms2 = cuda_ms(lambda: RG.rglru_scan(*args), iters=100, warmup=10)
        nbytes = 3 * 2 * B * L * W + 4 * W + 2 * B * W + 4 * B * L * W + 4 * B * W
        nops = 16 * B * L * W        # gates, exps, sqrt and the update, per element
        bound_ms, by = _bound(nbytes, nops, F32_OPS_PER_S)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops)
        emit("timing", name="rglru_scan", case=name, dtype="bfloat16", x=[B, L, W],
             library_ms=None, **out[name])
    d = out["prefill_1x2048x4096"]
    return {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:47",
            "launches": int(launches), "max_abs_err": max(errs["rglru_scan"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None,
            "decode": out["decode_4x1x4096"]}


def phase_timing(problem, ladder_launches, serve, errs):
    kernels = []
    if problem is not None:
        kernels.append(_ladder_timing(problem, ladder_launches, errs))
    if serve:
        by_arch = {arch: r["launches"] for arch, r in serve.items()}
        total = {k: sum(n[k] for n in by_arch.values()) for k in COUNTED}
        rows = [_flash_timing(total["flash_attention"], errs)]
        if serve.get("granite_moe_1b"):
            rows.append(_moe_timing(serve["granite_moe_1b"]["moe"], total["moe_gmm"], errs))
        if serve.get("mamba2_2p7b"):
            rows.append(_ssd_timing(total["ssd_intra_chunk"], errs))
        if serve.get("recurrentgemma_9b"):
            rows.append(_rglru_timing(total["rglru_scan"], errs))
        for row in rows:
            row["launches_by_arch"] = {a: n[row["name"]] for a, n in by_arch.items()}
        kernels += rows
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
    serve = {}
    if "serve" in only:
        for arch in SERVE_ARCHS:
            serve[arch] = phase_serve(arch)
            torch.cuda.empty_cache()
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
