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
   the ladder grant at the SoA path's widths (exact equality); the fused
   EDF allocator (``alloc_ladder``: allocation, allocation + tp's bump,
   Phase B's start validation) at R=1024 over P 1/4/21, C 1/6, W 8-1520
   (exact equality, ``ALLOC_CASES``); flash
   attention and the MoE grouped matmul at the serve path's shapes, at the
   reference's kernel-test sweep shapes and through offset / ragged-cache
   decode cases, in bf16 and f32 (tolerances ``TOL``); the SSD intra-chunk
   kernel at the sweep shapes, mamba2-2.7b's full width (L = 1024 and a
   ragged L = 600), the serve prefill and the tensor-core design's tile
   edges, and ``ops.ssd_chunked`` against the model-level chunked scan
   with a nonzero initial state (``TOL_SSD``); the RG-LRU scan at the
   sweep shapes, recurrentgemma's prefill ``(1, 2048, 4096)``, serve
   prefill ``(1, 16, 4096)`` and decode ``(4, 1, 4096)``, and the chunked
   design's edges (L = 2047, 2049; W = 100); flash attention at
   D = 256 on 128-slot rings (part-filled and wrapped ``kv_positions``);
   the forward's log-sum-exp (split plans included) and attention's
   backward (``flash_attention_bwd``) at phi4-mini's train shape, a
   2048-token one and the forward's prefill and sweep cases, in bf16 and
   f32 (``TOL_BWD``); the widths of the last six archs: flash at D = 96,
   160 and 192 (padded in the kernel), gemma2's softcap in its 4096
   window and gemma3's D = 256 at g = 2, and ``moe_gmm`` at deepseek-v2's
   D = 5120 (its serve shape, a narrow E, an F no multiple of 64), also
   against the float64 oracle; the backward kernels of ``moe_gmm``,
   ``ssd_intra_chunk`` and ``rglru_scan`` at the train shapes (granite's
   C = 320, deepseek's D 5120 / F 1536 at a small C, mamba2's one chunk of
   128 and four of 256, recurrentgemma's (8, 128, 4096) and L = 13 / 2047 /
   2049), in bf16 and f32, each gradient to a share of its largest entry
   (``TOL_BWD_MAX``; the SSD backward under every combination of its three
   gradients; the designs each bf16 call takes asserted, the designs they
   replaced launched by name on the same inputs, a repeated call
   bit-equal), and ``ops.ssd_chunked``'s gradients on the card against the
   CPU at four chunks of 256;
4. ``sampler`` — the torch trace sampler on the card against the NumPy
   host path (R=1024, ``rtol=1e-12``);
5. ``main``    — ``run(commute, ads_tile, cockpit_replicas=4, seeds=range
   (1024), backend="soa")`` on the card, cold and warm, with every launch
   counter set to 0 just before each run and read just after (the fused
   allocator 3 times per round, every other kernel never);
6. ``loop``    — the round loop on the card against the same loop on the
   CPU (which the CPU tests hold against the JAX reference);
7. ``equiv``   — SoA on the card against the port's own scalar engine
   (structural invariants exact, pooled KS <= 0.08, CI overlap);
8. ``lockstep`` — ``run(spec, seeds=range(8), device="cuda")`` with no
   backend for commute x cyc / cyc_s / tp_driven / ads_tile goes to the
   lockstep engine (one batch, no kernel launched) and gives the scalar
   engine's report digests; degraded_commute with ``backend="soa",
   fallback=True`` falls back to lockstep (scalar digests) and with
   ``fallback=False`` raises ``SoaUnsupported``; host wall of the lockstep
   fan against the scalar loop;
9. ``sweep``   — ``sweep(n_scenarios=4, policies=(ads_tile, tp_driven),
   backend="soa", device="cuda", jobs=1)`` with every launch counter set to
   0 just before and read just after (the fused allocator launched, the
   standalone grant not), the same sweep on lockstep (the same cells and
   cell keys; the equiv gate on each policy's reports), a lockstep
   campaign run twice into a temporary cache (the repeat executes no
   cell), and a recorded lockstep lane exported with
   ``export_chrome_trace`` and checked with ``validate_trace``;
10. ``profile`` — the round loop over the main path's first 100 rounds at
   R=1024, for ads_tile and tp_driven: wall ms, kernels per round, device
   busy ms and idle share (torch.profiler), the fused allocator's device ms
   and launches per round, the loop's peak device memory; every 10th
   allocation replayed through kernel and plain version (equal), and 20
   rounds under a dispatch mode that fails on any (R, W, W) output;
11. ``serve``   — the LM serving path, for each arch of ``SERVE_ARCHS`` in
   turn (every arch but phi4-mini, which ``train`` runs; each freed
   before the next is built): ``ServingEngine``
   at full width in bf16 (random weights from seed 0; deepseek-v2 at
   depth 4, ``SERVE_LAYERS``, printed under ``reduced``) with the
   reference launcher's traffic (12 requests, prompt 16, 16 new tokens,
   batch 4, max_len 128), every launch counter set to 0 just before and
   read just after, and each kernel's count asserted; musicgen, which
   the engine cannot feed (ROADMAP C14), the same traffic through
   ``LM.prefill`` / ``decode_step`` with (B, 4, S) tokens; tokens/s,
   request and first-token latency, weight bytes, peak memory; a
   profiled window of decode steps (``serve_profile``); one request's
   prefill and 4 decode steps held against the port's CPU path on the
   same weights, widened to float32 on both sides (``serve_xcheck``;
   ``XCHECK_LAYERS`` cuts the depth where the float32 copy would not fit
   the host); phi-3-vision's image request (``serve_patches``: 576 patch
   embeddings and 16 tokens in one prefill, then 4 decode steps; its
   cross-check takes the same patches); one long request on the same
   weights for mamba2-2.7b, recurrentgemma-9b, gemma3-4b and gemma2-27b
   (``serve_long``: prompt 1024 / 2032 / 2048 / 4608, the last two past
   the windows; launches asserted, first-token latency, a profiled
   prefill's device ms and the SSD / RG-LRU / flash kernel's share of
   it); ``moe_gmm`` timed at deepseek-v2's serve shape on its own
   experts;
12. ``train``   — ``Trainer`` on each of ``TRAIN_STACKS`` in turn at full
   width in bf16 (seed 0, batch 8 x seq 128, 4 steps): phi4-mini,
   granite-moe-1b and mamba2-2.7b at full depth, recurrentgemma-9b at
   depth 12; every launch counter set to 0 just before and read just
   after (each forward kernel twice per layer a step under remat, its
   backward once), the same counts per step from a profiled step's device
   kernels, every parameter leaf's gradient finite and nonzero at step 1,
   step wall ms, tokens/s, peak memory, device busy ms, idle share and
   each kernel's device ms; mamba2 also 2 steps at batch 2 x seq 1024
   (``TRAIN_LONG``: the inter-chunk gradients); per stack one step's loss
   and gradients on the card against the CPU at full width, depth 2 (the
   hybrid 3), in float32 (``TRAIN_XCHECK``; the MoE routing equal), and a
   checkpoint save and resume in bf16 whose next loss equals the
   uninterrupted run's bit for bit;
13. ``mesh_train`` — ``Trainer(cfg, tcfg, mesh=mesh)`` for granite-moe-1b
   at full width on a ``(data, model) = (1, 1)`` DeviceMesh
   (``ElasticMesh(model_parallel=1).mesh_for()`` under NCCL, world size
   1): parameters and AdamW moments DTensors, the MoE's expert-parallel
   branch and every kernel call through ``local_map``; three steps of
   batch 8 x 128 bit-equal to ``Trainer(mesh=None)`` (losses, every
   parameter, the launch counts, each counted from 0 around its run),
   step ms and peak memory beside the unsharded run's; one save on the
   mesh and a restore without it, the next loss bit-equal;
14. ``colocated`` — ``examples/serve_colocated.py``'s scenario at full
   width: phi4-mini and granite-moe-1b in partition 0, gemma3-4b and
   stablelm-12b in partition 1 (41.4 GB of bf16 weights), variants b1 / b4
   whose calls end in ``torch.cuda.synchronize()`` (estimates synchronised
   too), six chained bursts, once with the example's budgets and
   deadlines and once with each times 10 (the example's are set for its
   reduced CPU models); per model jobs, variants, estimated and
   actual ms, latency p50 / p99, drops and misses; the launches (counted
   from 0 around the run) one flash forward per attention layer per job
   that ran, one ``moe_gmm`` per MoE layer per planner job;
15. ``dryrun`` — two production-mesh cells of ``repro_torch.launch.dryrun``
   on fake tensors under a fake process group (granite-moe-1b
   ``train_4k`` on ``pod16x16``, deepseek-v2 ``decode_32k`` on
   ``pod2x16x16``): status OK, terms finite, the card untouched; asked
   for CUDA, it raises;
16. ``timing`` — kernel, plain-version, library and bound times at each
   path's shapes (the backward kernels at the train shapes, the SSD and
   RG-LRU ones beside the designs they replaced and with the L2 flushed
   between calls), then the ``kernels`` line; ``moe_gmm`` is also held on
   granite-moe's own expert weights against the float32 references and a
   float64 oracle (``TOL_MOE_MODEL``), and with ``--moe-baseline
   OTHER/moe_gmm.cu`` another build of it is timed beside this one and
   must give this one's bits;
17. ``flash_ab`` (only with ``--flash-baseline OTHER/src``) — flash
   attention's per-call and device time at the serve shapes from another
   tree and from this one, each in a fresh process;
18. ``soa_ab`` (only with ``--soa-baseline OTHER/src``) — the SoA main path
   (ads_tile and tp_driven, cold and warm) and its 100-round profile from
   another tree and from this one, each in a fresh process, in the order
   baseline, this, this, baseline;
19. ``ssm_ab`` (only with ``--ssm-baseline OTHER/src``) — ``ssd_intra_chunk``
   and ``rglru_scan`` per-call and device ms at their long and serve shapes
   (``SSM_AB_CASES``) from another tree and from this one, each in a fresh
   process, in the same order.

Any failed check exits non-zero.  Without a CUDA device it exits 2 before
printing any result.  The last line is ``{"ok": true, "device": ...}``.
"""
import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
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
from repro_torch.models.lm import train_step_fn  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402
from repro_torch.training.data import DataConfig, synthetic_stream  # noqa: E402
from repro_torch.core.sim import soa  # noqa: E402
from repro_torch.core.sim import soa_kernels as K  # noqa: E402
from repro_torch.core.sim.batch import report_digest, sample_trace_batch  # noqa: E402
from repro_torch.core.sim.trace import build_skeleton  # noqa: E402
from repro_torch.obs import TraceRecorder, export_chrome_trace, metrics  # noqa: E402
from repro_torch.obs import validate_trace  # noqa: E402
from repro_torch.scenarios import ScenarioSpec, aggregate_sweep, get_scenario  # noqa: E402
from repro_torch.scenarios import run, runner, sweep  # noqa: E402
from repro_torch.sweeps import CampaignSpec, cell_key, run_campaign  # noqa: E402

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, non-tensor fp32 rate and
#: dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

PHASES = ("device", "build", "kernel", "sampler", "main", "loop", "equiv",
          "lockstep", "sweep", "profile", "serve", "train", "mesh_train", "colocated",
          "dryrun", "timing")
KERNELS = ("ladder_grant", "flash_attention", "flash_attention_bwd", "moe_gmm",
           "moe_gmm_bwd", "ssd_intra_chunk", "ssd_intra_chunk_bwd", "rglru_scan",
           "rglru_scan_bwd")
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


def main_spec(policy="ads_tile", **kw):
    return ScenarioSpec(
        scenario=get_scenario("commute"), policy=policy, cockpit_replicas=4, **kw
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


def alloc_inputs(R, W, C, P, seed, kind="", part_rows=None, cand_lanes=False,
                 cap_rows=None):
    """Integer queues for the fused EDF allocator, as the round loop builds
    them (tests/test_torch_soa_alloc.py's): ladders sorted and padded by
    repeating the last rung, wants on the ladder or 0, partition ids with a
    few out of range, a random EDF permutation."""
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


#: (P, C, W, kind, part rows, per-lane ladders, cap rows): P in {1, 4, 21}
#: (tp_driven, ads_tile, cyc at replicas=4), C in {1, 6}, W from 8 to the
#: full-horizon window of the widest bundled cell (rate_churn, 1520); empty
#: entry masks, wants above every cap, empty pools; the argument layouts
ALLOC_CASES = (
    [(P, C, W, "", None, False, None) for P in (1, 4, 21) for C in (1, 6)
     for W in (8, 96, 160, 300, 1520)]
    + [(P, 6, 160, k, None, False, None) for P in (1, 4)
       for k in ("empty", "want_high", "pool_zero")]
    + [(4, 6, 96, "", pr, cl, cr) for pr, cl, cr in
       ((1, False, None), (None, False, 1), (None, True, None), (1, True, 1))]
)


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


def sass_counts(lib):
    """Per kernel function of a built library: its tensor-core products
    (HMMA), ldmatrix (LDSM) and cp.async (LDGSTS) instructions, from
    ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump -sass {lib}: {res.stderr[-500:]}")
    out, fn = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[-1].strip()
            out[fn] = dict.fromkeys(("HMMA", "LDSM", "LDGSTS"), 0)
        elif fn is not None:
            for op in out[fn]:
                if f" {op}." in ln or f" {op} " in ln:
                    out[fn][op] += 1
    return out


def phase_build():
    t = time.perf_counter()
    libs = _cuda.build(KERNELS)
    # ptxas's report per kernel function: registers, spills, shared memory
    keep = ("Compiling entry", "Used", "spill")
    emit("build", seconds=time.perf_counter() - t,
         libs={k: os.path.basename(str(v)) for k, v in libs.items()},
         ptxas={k: [ln.split("ptxas info    : ")[-1] for ln in v.splitlines()
                    if any(w in ln for w in keep)]
                for k, v in _cuda.BUILD_LOG.items()})
    for name in ("flash_attention", "flash_attention_bwd", "moe_gmm", "moe_gmm_bwd",
                 "ssd_intra_chunk", "ssd_intra_chunk_bwd"):
        counts = sass_counts(libs[name])
        emit("sass", kernel=name, functions=counts)
        mma = [f for f in counts if "mma_kernel" in f]
        # the SSD backward's kernels stage by cp.async (main, dB / dC) or by
        # registers (the sum kernel's contrib GEMM): HMMA and LDSM in each
        ops = ("HMMA", "LDSM") if name == "ssd_intra_chunk_bwd" else ("HMMA", "LDSM", "LDGSTS")
        check(mma and all(counts[f][op] > 0 for f in mma for op in ops),
              f"{name}: a tensor-core kernel lacks {' / '.join(ops)}: {counts}")
    # registers and spills of every tensor-core kernel and of the RG-LRU
    # backward's vectorised one (ptxas's report of this build); the
    # backwards' must not spill
    bwd = ("flash_attention_bwd", "moe_gmm_bwd", "ssd_intra_chunk_bwd", "rglru_scan_bwd")
    spills = {name: {f: sp for f, sp in ptxas_spills(log).items()
                     if "mma_kernel" in f or "vec_kernel" in f}
              for name, log in _cuda.BUILD_LOG.items()}
    emit("spills", mma_functions=sum(map(len, spills.values())),
         spilling={f: sp[:2] for per in spills.values() for f, sp in per.items() if any(sp[:2])},
         bwd_registers={_short(f): sp[2] for name in bwd
                        for f, sp in spills.get(name, {}).items()})
    bad = [f for name in bwd for f, sp in spills.get(name, {}).items() if any(sp[:2])]
    check(not bad, f"a backward kernel spills: {bad}")


def ptxas_spills(log):
    """Per kernel function of a ``ptxas -v`` report: (spill store bytes,
    spill load bytes, registers)."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn is not None and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            out[fn] = (int(m.group(1)), int(m.group(2)), 0)
        elif fn is not None and "Used" in ln and fn in out:
            m = re.search(r"Used (\d+) registers", ln)
            out[fn] = (*out[fn][:2], int(m.group(1)) if m else 0)
            fn = None
    return out


def _short(fn):
    """A mangled kernel name cut to its own name and template arguments."""
    m = re.search(r"\d+((?:flash|moe|ssd|rglru)_\w*?kernel)(\w*)", fn)
    if not m:
        return fn
    args = re.findall(r"Li(\d+)E", m.group(2).split("Ev")[0])
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


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
     ("decode_softcap_d128", 3, 4, 1, 1, 70, 128, 65, 66, 0, 30.0),
     # tile edges of the tensor-core / split-KV design: g in {1, 2, 4, 16},
     # D in {32, 64, 128, 256}, Lk not a multiple of the tile, key ranges
     # split over blocks (decodes) and not (long prefills)
     ("decode_g1_d32_lk100", 2, 4, 4, 1, 100, 32, 70, 71, 0, 0.0),
     ("decode_g2_d64_ragged_window", 3, 4, 2, 1, 77, 64, 60, 61, 16, 0.0),
     ("decode_g16_d256_lk1000", 2, 16, 1, 1, 1000, 256, 900, 901, 0, 0.0),
     ("prefill_g4_d128_window", 1, 8, 2, 40, 300, 128, 200, 240, 64, 0.0),
     ("prefill_g16_d256_L300", 1, 16, 1, 300, 300, 256, 0, 300, 2048, 0.0)]
    + [(f"sweep_{b}x{hq}x{hkv}x{l}x{d}_w{w}_c{int(c)}", b, hq, hkv, l, l, d, 0, l, w, c)
       for (b, hq, hkv, l, d) in [(1, 4, 4, 128, 64), (2, 8, 2, 96, 32), (1, 4, 1, 256, 128)]
       for (w, c) in [(0, 0.0), (32, 0.0), (0, 50.0)]]
    # the widths the last six archs serve at: phi-3-vision's D = 96 (padded
    # to 128 in the kernel) over its 576 patches + 16 tokens and decoding;
    # stablelm's D = 160 and the MLA prefill's D = 192 (both padded to
    # 256; MLA at Hq = Hkv = 128); gemma2's softcap 50 in its window of
    # 4096 past the window; gemma3's D = 256 at g = 2 in its window of 1024
    + [("phi3v_patch_prefill_d96", 1, 32, 32, 592, 592, 96, 0, 592, 0, 0.0),
       ("phi3v_decode_d96", 4, 32, 32, 1, 640, 96, 595, 596, 0, 0.0),
       ("stablelm_prefill_d160", 1, 32, 8, 16, 128, 160, 0, 16, 0, 0.0),
       ("stablelm_decode_d160", 4, 32, 8, 1, 128, 160, 30, 31, 0, 0.0),
       ("mla_prefill_d192", 1, 128, 128, 16, 16, 192, 0, 16, 0, 0.0),
       ("mla_prefill_d192_L300", 1, 128, 128, 300, 300, 192, 0, 300, 0, 0.0),
       ("gemma2_decode_softcap50_w4096", 2, 32, 16, 1, 4624, 128, 4610, 4611, 4096, 50.0),
       ("gemma2_prefill_softcap50_w4096", 1, 32, 16, 64, 4624, 128, 4560, 4624, 4096, 50.0),
       ("gemma3_prefill_d256_g2_w1024", 1, 8, 4, 100, 2048, 256, 1948, 2048, 1024, 0.0),
       ("gemma3_decode_d256_g2_w1024", 4, 8, 4, 1, 2064, 256, 2050, 2051, 1024, 0.0)]
)

#: attention's backward, kernel vs plain version on the same q, k, v, out,
#: lse and dout: float32 sums of up to 3 x 2048 products in another order
#: (the bf16 band is TOL's: each gradient is rounded to bf16 once on both
#: sides)
TOL_BWD = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: TOL[torch.bfloat16]}
#: the backward kernel against SDPA's backward (the timing yardstick, same
#: function): SDPA's bf16 backward rounds p and ds to bf16 before its
#: products, where the kernel keeps them float32, so the two differ by a
#: few bf16 roundings of each term, not one rounding of each output
TOL_BWD_LIB = {torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
#: the forward's log-sum-exp against the plain version's: float32 on both
#: sides from the same float32 logits, summed in another order
TOL_LSE = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=1e-5, atol=1e-4)}
#: (name, B, Hq, Hkv, Lq, Lk, D, q_offset, kv_valid_len, window, softcap):
#: phi4-mini's train shape (batch 8, 24 query heads on 8 KV heads of 128,
#: 128 tokens), a 2048-token sequence at its width, and the forward's
#: prefill and sweep cases with more than one query row (windows, softcap,
#: offsets, D = 32..256, G = 1..16)
BWD_CASES = (
    [("phi4_train", 8, 24, 8, 128, 128, 128, 0, 128, 0, 0.0),
     ("phi4_L2048", 1, 24, 8, 2048, 2048, 128, 0, 2048, 0, 0.0),
     # the train shapes of granite-moe (16 query heads on 8 KV heads of 64)
     # and of recurrentgemma's local attention (16 on 1 of 256: the
     # CUDA-core design, window 2048)
     ("granite_train", 8, 16, 8, 128, 128, 64, 0, 128, 0, 0.0),
     ("rg_train_d256", 8, 16, 1, 128, 128, 256, 0, 128, 2048, 0.0)]
    + [c for c in FLASH_CASES if c[4] > 1]
)

#: (name, E, C, D, F, weight scale): the serve path (granite-moe-1b:
#: 32 experts, capacity 8, d_model 1024, d_ff 512; weights at the model's
#: init scale) and C in {1, 10, 320} at its width (320: a 1024-token
#: prefill's buckets, int(1.25 * 8 * 1024 / 32)), tests/test_kernels.py's
#: sweep, the reduced config
MOE_CASES = [
    ("serve", 32, 8, 1024, 512, None),
    ("c1", 32, 1, 1024, 512, None),
    ("c10", 32, 10, 1024, 512, None),
    ("prefill_c320", 32, 320, 1024, 512, None),
    ("sweep_4x64x32x64", 4, 64, 32, 64, 0.1),
    ("sweep_8x96x16x32", 8, 96, 16, 32, 0.1),
    ("reduced_4x10x64x32", 4, 10, 64, 32, None),
    # deepseek-v2's serve shape (160 experts, capacity 8, d_model 5120,
    # expert d_ff 1536: more than one panel of D), and D = 5120 at a narrow
    # E with C = 20 (32 rows a pass) and an F that is no multiple of 64
    ("deepseek_serve", 160, 8, 5120, 1536, None),
    ("narrow_e4_c20_d5120", 4, 20, 5120, 1536, None),
    ("narrow_e2_c8_d5120_f200", 2, 8, 5120, 200, None),
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
    # tile edges of the tensor-core design: C = 40 and 256 with ragged L,
    # odd head counts, P = 8 and 128, N = 24 and 256, nb > 1; P = 4 (the
    # CUDA cores in bf16 too)
    ("edge_c40_h3_p8_n24", 2, 100, 3, 8, 24, 40),
    ("edge_c40_h5_p128_n256", 1, 120, 5, 128, 256, 40),
    ("edge_c256_h5_p128_n24_ragged", 1, 700, 5, 128, 24, 256),
    ("edge_c256_h3_p8_n256_ragged", 1, 300, 3, 8, 256, 256),
    ("edge_c256_h3_p64_n128_b2", 2, 512, 3, 64, 128, 256),
    ("edge_c32_h3_p4_n16", 1, 64, 3, 4, 16, 32),
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
               ("prefill_1x2048x4096", 1, 2048, 4096), ("decode_4x1x4096", 4, 1, 4096),
               # the chunked design's edges: L = 1, 16 (the short-L form),
               # 2047 and 2049 (chunks not dividing L), B = 4, W = 100 (one
               # channel per thread)
               ("serve_prefill_1x16x4096", 1, 16, 4096), ("ragged_1x2047x4096", 1, 2047, 4096),
               ("ragged_4x2049x256", 4, 2049, 256), ("ragged_4x2049x100", 4, 2049, 100),
               ("decode_4x1x100", 4, 1, 100), ("short_4x16x100", 4, 16, 100)]

#: (name, B, Hq, Hkv, W slots, D, pos, window): recurrentgemma's decode on
#: its 128-slot ring (16 query heads on one KV head of 256), part-filled
#: (empty slots at negative positions) and wrapped; and a window inside the
#: ring at a smaller head dim
RING_CASES = [("ring_part_filled_d256", 4, 16, 1, 128, 256, 40, 2048),
              ("ring_wrapped_d256", 4, 16, 1, 128, 256, 300, 2048),
              ("ring_wrapped_window_d64", 2, 8, 2, 64, 64, 150, 48),
              # split-KV ranges of empty slots; a ring not a tile multiple
              ("ring_mostly_empty_d64_g2", 4, 16, 8, 256, 64, 5, 4096),
              ("ring_mostly_empty_d128_g4", 2, 8, 2, 192, 128, 20, 4096),
              ("ring_wrapped_d32_g1_w100", 2, 4, 4, 100, 32, 250, 4096),
              # recurrentgemma past its window: a full, wrapped 2048-slot ring
              ("ring2048_wrapped_d256", 4, 16, 1, 2048, 256, 3000, 2048)]


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

    # the fused EDF allocator, exact: allocation, allocation + bump, and
    # the start validation, each against its plain version on the card
    for (P, C, W, kind, pr, cl, cr) in ALLOC_CASES:
        # 128 lanes at W = 1520, where the plain version's (R, W, W) masks
        # would take 28 GB
        R = MAIN_R if W <= 300 else 128
        want, entry, part, cand, cap, perm = alloc_inputs(
            R, W, C, P, seed=P * 1000 + C * 10 + W, kind=kind, part_rows=pr,
            cand_lanes=cl, cap_rows=cr)
        tag = f"alloc_ladder P={P} C={C} W={W} {kind} {pr} {cl} {cr}"
        for iters, bump in ((3, None), (8, 8)):
            before = K.edf_alloc_ladder.launches
            got = K.edf_alloc_ladder(want, entry, part, cand, cap, perm,
                                     alloc_iters=iters, bump_passes=bump)
            check(K.edf_alloc_ladder.launches == before + 1, f"{tag}: no launch")
            plain = K._edf_alloc_ladder(want, entry, part, cand, cap, perm, iters, bump)
            torch.cuda.synchronize()
            errs["alloc_ladder"].append(float((got - plain).abs().max()))
            check(torch.equal(got, plain), f"{tag} bump={bump}: differs from plain")
        d = torch.where(entry, want, torch.zeros_like(want))
        got = K.edf_start_keep(d, part, cap, perm)
        torch.cuda.synchronize()
        check(torch.equal(got, K._edf_start_keep(d, part, cap, perm)), f"{tag}: start_keep")
    emit("kernel", name="alloc_ladder", cases=len(ALLOC_CASES),
         shapes="R=1024 (128 at W=1520), P 1/4/21, C 1/6, W 8-1520; alloc, +bump, "
                "start validation", exact=True, max_abs_err=max(errs["alloc_ladder"]))

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
    _bwd_kernel_checks(errs)

    res = {}
    for i, (name, E, C, D, Fd, scale) in enumerate(MOE_CASES):
        for dtype in DTYPES:
            x, wg, wu, wd = moe_inputs(E, C, D, Fd, scale, dtype, seed=500 + 10 * i)
            before = MG.moe_gmm.launches
            got = MG.moe_gmm(x, wg, wu, wd)
            check(MG.moe_gmm.launches == before + 1, f"moe_gmm {name}: no launch")
            err = _held(got, MG.moe_gmm_plain(x, wg, wu, wd), dtype, f"moe_gmm {name} {dtype}")
            _held(got, kref.moe_gmm_ref(x, wg, wu, wd), dtype, f"moe_gmm {name} {dtype} vs ref")
            if D > 1024:
                _held(got, MG.moe_gmm_oracle64(x, wg, wu, wd), dtype,
                      f"moe_gmm {name} {dtype} vs the float64 oracle")
            del x, wg, wu, wd, got
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
    _train_bwd_kernel_checks(errs)


def _bwd_kernel_checks(errs):
    """The forward's log-sum-exp on every plan (split-KV decodes included)
    and the backward kernel against their plain versions."""
    res, splits = {}, 0
    for i, (name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, c) in enumerate(FLASH_CASES):
        for dtype in DTYPES:
            q, k, v = flash_inputs(B, Hq, Hkv, Lq, Lk, D, dtype, seed=100 + 10 * i)
            kw = dict(causal=True, window=w, softcap=c, q_offset=qo, kv_valid_len=kvl)
            out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
            pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
            _held(out, pout, dtype, f"flash_attention {name} {dtype} with lse")
            res[f"{name}/{str(dtype)[6:]}"] = _held(lse, plse, dtype, f"lse {name} {dtype}",
                                                    TOL_LSE)
            splits = max(splits, FA.flash_plan(dtype, B, Hq, Hkv, Lq, Lk, D,
                                               n_sm=FA._sm_count(0), window=w, q_offset=qo,
                                               kv_valid_len=kvl).splits)
    check(splits > 1, "no lse case ran a split plan")
    emit("kernel", name="flash_attention_lse", cases=len(res), most_splits=splits,
         tol={str(k)[6:]: v for k, v in TOL_LSE.items()}, max_abs_err=max(res.values()),
         max_abs_err_by_case=res)

    res, paths, lib_err, groups = {}, {}, {}, {}
    for i, (name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, c) in enumerate(BWD_CASES):
        for dtype in DTYPES:
            q, k, v = flash_inputs(B, Hq, Hkv, Lq, Lk, D, dtype, seed=800 + 10 * i)
            kw = dict(causal=True, window=w, softcap=c, q_offset=qo, kv_valid_len=kvl)
            out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
            dout = _randn(out.shape, dtype, seed=805 + 10 * i)
            before = FA.flash_attention_bwd.launches
            got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            check(FA.flash_attention_bwd.launches == before + 1, f"flash bwd {name}: no launch")
            want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
            err = 0.0
            for g, wnt, part in zip(got, want, ("dq", "dk", "dv")):
                check(g.dtype == dtype and g.shape == wnt.shape, f"flash bwd {name} {part}")
                err = max(err, _held(g, wnt, dtype, f"flash_attention_bwd {name} {dtype} {part}",
                                     TOL_BWD))
            errs["flash_attention_bwd"].append(err)
            res[f"{name}/{str(dtype)[6:]}"] = err
            plan = FA.flash_bwd_plan(dtype, B, Hq, Hkv, Lq, Lk, D)
            paths[plan.path] = paths.get(plan.path, 0) + 1
            if dtype != torch.bfloat16:
                continue
            check(plan.path == "mma", f"flash bwd {name}: bf16 at D = {D} runs {plan.path}")
            # a second call on the same inputs gives the same bits (no atomics)
            again = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {name}: two calls differ")
            lib = _sdpa_bwd(q, k, v, dout, qo, kvl, w) if c == 0 else None
            if lib is not None:
                lib_err[name] = max(_held(g, wnt, dtype, f"flash_attention_bwd {name} {part} vs "
                                          f"SDPA's backward", TOL_BWD_LIB)
                                    for g, wnt, part in zip(got, lib, ("dq", "dk", "dv")))
            groups[name] = plan.groups
    check(set(paths) == {"mma", "fma"}, f"flash bwd: both designs must be checked, got {paths}")
    emit("kernel", name="flash_attention_bwd", cases=len(res), cases_by_path=paths,
         tol={str(k)[6:]: v for k, v in TOL_BWD.items()},
         max_abs_err=max(errs["flash_attention_bwd"]), max_abs_err_by_case=res,
         bf16_bit_equal_repeat=True, head_groups=groups,
         vs_sdpa_bwd_tol=TOL_BWD_LIB[torch.bfloat16], vs_sdpa_bwd_max_abs_err=lib_err,
         not_vs_sdpa="softcap (SDPA has none)")


def _sdpa_bwd(q, k, v, dout, q_offset, kv_valid_len, window):
    """SDPA's backward (``scaled_dot_product_attention`` under autograd,
    GQA, the same causal / window / offset / valid-length mask) on the same
    inputs; None where a query row sees no key (SDPA gives it NaN)."""
    import torch.nn.functional as F

    Lq, Lk = q.shape[2], k.shape[2]
    qpos = q_offset + torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = (kpos < kv_valid_len) & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    if not bool(mask.any(dim=1).all()):
        return None
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, enable_gqa=True)
    return torch.autograd.grad(o, (ql, kl, vl), dout)


#: the MoE, SSM and hybrid stacks' backward kernels against their plain
#: versions on the same inputs: each gradient to a share of its largest
#: entry.  float32: sums of up to H P = 5120 products in another order, and
#: d acum's row sums less its column sums, which cancel to far below the
#: terms; bf16: one rounding of each output on both sides (2^-8) and
#: a = bf16(silu(h) u) rounding the other way where a float32 sum of h or u
#: lands otherwise
TOL_BWD_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: (name, E, C, D, F): granite-moe-1b's train shape (32 experts, capacity
#: int(1.25 * 8 * 1024 / 32) = 320 rows) and its serve capacity, deepseek-v2's
#: expert shape (D 5120, F 1536) at a small C over all 160 experts (bf16) and
#: over 8, ragged tiles
MOE_BWD_CASES = [("granite_train_c320", 32, 320, 1024, 512),
                 ("granite_c8", 32, 8, 1024, 512),
                 ("deepseek_e160_c8", 160, 8, 5120, 1536),
                 ("deepseek_e8_c20", 8, 20, 5120, 1536),
                 ("ragged_3x70x40x72", 3, 70, 40, 72)]
#: (name, B, L, H, P, N, chunk): mamba2-2.7b's train shapes (batch 8 x seq
#: 128: one chunk of 128; batch 2 x seq 1024: four chunks of 256), a ragged
#: L = 600 at its width, and the forward's tile-edge shapes
SSD_BWD_CASES = [("mamba2_train_L128", 8, 128, 80, 64, 128, 256),
                 ("mamba2_train_L1024", 2, 1024, 80, 64, 128, 256),
                 ("ragged_L600", 1, 600, 80, 64, 128, 256),
                 ("edge_c40_h3_p8_n24", 2, 100, 3, 8, 24, 40),
                 ("edge_c256_h5_p128_n256", 1, 300, 5, 128, 256, 256),
                 ("edge_c32_h3_p4_n16", 1, 64, 3, 4, 16, 32)]
#: (name, B, L, W): recurrentgemma-9b's train shape, and the forward's L
#: edges at its width (13, 2047, 2049), a width no multiple of 8, L = 1
RGLRU_BWD_CASES = [("rg_train_8x128x4096", 8, 128, 4096), ("L13_2x13x4096", 2, 13, 4096),
                   ("L2047_1x2047x4096", 1, 2047, 4096), ("L2049_1x2049x4096", 1, 2049, 4096),
                   ("w100_4x2049x100", 4, 2049, 100), ("L1_4x1x100", 4, 1, 100)]


def _held_max(got, want, dtype, what, tol=TOL_BWD_MAX):
    """``got`` within ``tol[dtype]`` of ``want``'s largest entry; returns
    the max abs error."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= tol[dtype] * scale, f"{what}: max abs err {err} of largest entry {scale}")
    return err


def moe_bwd_plain_by_experts(x, wg, wu, wd, dy, per=32):
    """``moe_gmm_bwd_plain`` over slices of ``per`` experts (each expert's
    gradients are its own), so the float32 copies of deepseek's 160 experts
    never all exist at once."""
    parts = [MG.moe_gmm_bwd_plain(*(t[e:e + per] for t in (x, wg, wu, wd, dy)))
             for e in range(0, x.shape[0], per)]
    return tuple(torch.cat(p) for p in zip(*parts))


def ssd_bwd_inputs(B, L, H, P, N, chunk, dtype, seed):
    """The chunk-major inputs of ``ssd_intra_chunk`` (``ssd_inputs``) and
    float32 gradients of its three outputs."""
    x, dt, A, Bm, Cm = ssd_inputs(B, L, H, P, N, dtype, seed)
    xc, dtc, Bc, Cc = ssd_chunks(x, dt, Bm, Cm, chunk)
    _, nb, c, _, _ = xc.shape
    grads = (_randn((B, nb, c, H, P), torch.float32, seed + 5),
             _randn((B, nb, H, P, N), torch.float32, seed + 6),
             _randn((B, nb, H), torch.float32, seed + 7))
    return (xc, dtc, A, Bc, Cc), grads


def rglru_bwd_inputs(B, L, W, dtype, seed):
    """RG-LRU inputs, the forward kernel's h, and float32 gradients of h
    and h_T."""
    args = rglru_inputs(B, L, W, dtype, seed)
    out, _ = RG.rglru_scan(*args)
    return args, out, _randn((B, L, W), torch.float32, seed + 5), _randn((B, W), torch.float32,
                                                                         seed + 6)


def _train_bwd_kernel_checks(errs):
    """The backward kernels of moe_gmm, ssd_intra_chunk and rglru_scan
    against their plain versions, in bf16 and float32; ``ops.ssd_chunked``'s
    gradients on the card against the CPU at four chunks of 256."""
    res = {}
    for i, (name, E, C, D, Fd) in enumerate(MOE_BWD_CASES):
        for dtype in DTYPES:
            if E > 32 and dtype == torch.float32:
                continue               # 160 experts' float32 gradients: 15 GB a copy
            x, wg, wu, wd = moe_inputs(E, C, D, Fd, None, dtype, seed=1500 + 10 * i)
            dy = _randn((E, C, D), dtype, seed=1505 + 10 * i)
            before = MG.moe_gmm_bwd.launches
            got = MG.moe_gmm_bwd(x, wg, wu, wd, dy)
            check(MG.moe_gmm_bwd.launches == before + 1, f"moe_gmm_bwd {name}: no launch")
            want = moe_bwd_plain_by_experts(x, wg, wu, wd, dy)
            err = 0.0
            for g, w, part in zip(got, want, ("dx", "dwg", "dwu", "dwd")):
                check(g.dtype == dtype, f"moe_gmm_bwd {name} {part}: dtype {g.dtype}")
                err = max(err, _held_max(g, w, dtype, f"moe_gmm_bwd {name} {dtype} {part}"))
            if dtype == torch.bfloat16:
                check(MG.moe_bwd_path(dtype, D, Fd) == "mma", f"moe_gmm_bwd {name}: not mma")
                # a second call on the same inputs gives the same bits (no atomics)
                again = MG.moe_gmm_bwd(x, wg, wu, wd, dy)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"moe_gmm_bwd {name}: two calls differ")
                del again
            del x, wg, wu, wd, dy, got, want
            errs["moe_gmm_bwd"].append(err)
            res[f"{name}/{str(dtype)[6:]}"] = err
    emit("kernel", name="moe_gmm_bwd", cases=len(res), bf16_path="mma", bf16_bit_equal_repeat=True,
         tol_of_max={str(k)[6:]: v for k, v in TOL_BWD_MAX.items()},
         max_abs_err=max(errs["moe_gmm_bwd"]), max_abs_err_by_case=res)

    res, paths = {}, {}
    for i, (name, B, L, H, P, N, chunk) in enumerate(SSD_BWD_CASES):
        for dtype in DTYPES:
            args, grads = ssd_bwd_inputs(B, L, H, P, N, chunk, dtype, seed=1700 + 10 * i)
            _, nb, c, _, _ = args[0].shape
            path = SSD.ssd_bwd_path(dtype, c, P, N)
            paths[f"{name}/{str(dtype)[6:]}"] = path
            check(path == ("mma" if dtype == torch.bfloat16 and P >= 8 else "fma"),
                  f"ssd_intra_chunk_bwd {name} {dtype}: design {path}")
            # every combination of the three gradients (None: zero)
            for mask in range(1, 8):
                gs = tuple(g if mask >> k & 1 else None for k, g in enumerate(grads))
                tag = "+".join(n_ for k, n_ in enumerate(("dy", "dcontrib", "ddecay"))
                               if mask >> k & 1)
                before = SSD.ssd_intra_chunk_bwd.launches
                got = SSD.ssd_intra_chunk_bwd(*args, *gs)
                check(SSD.ssd_intra_chunk_bwd.launches == before + 1,
                      f"ssd_intra_chunk_bwd {name}: no launch")
                want = SSD.ssd_intra_chunk_bwd_plain(*args, *gs)
                err = max(_held_max(g, w, dtype, f"ssd_intra_chunk_bwd {name} {tag} {dtype} {p}")
                          for g, w, p in zip(got, want, ("dx", "ddt", "dA", "dB", "dC")))
                if mask == 7:
                    # a second call on the same inputs gives the same bits (no atomics)
                    again = SSD.ssd_intra_chunk_bwd(*args, *gs)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"ssd_intra_chunk_bwd {name} {dtype}: two calls differ")
                    del again
                errs["ssd_intra_chunk_bwd"].append(err)
                res[f"{name}/{tag}/{str(dtype)[6:]}"] = err
            if dtype == torch.bfloat16 and path == "mma":
                # the design it replaced, launched by name on the same inputs
                got = SSD._ssd_intra_chunk_bwd_cuda(*args, *grads, design="fma")
                want = SSD.ssd_intra_chunk_bwd_plain(*args, *grads)
                err = max(_held_max(g, w, dtype, f"ssd_intra_chunk_bwd {name} fma {p}")
                          for g, w, p in zip(got, want, ("dx", "ddt", "dA", "dB", "dC")))
                errs["ssd_intra_chunk_bwd"].append(err)
                res[f"{name}/fma_design/bfloat16"] = err
            del args, grads
    # the op under autograd, four chunks of 256 at mamba2's width, float32:
    # the card (kernels) against the CPU (plain versions), gradients of y
    # and of the final state
    x, dt, A, Bm, Cm = ssd_inputs(1, 1024, 80, 64, 128, torch.float32, seed=1790)
    dy = _randn((1, 1024, 80, 64), torch.float32, seed=1791)
    ds = _randn((1, 80, 64, 128), torch.float32, seed=1792)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, st = kops.ssd_chunked(*leaves, chunk=256)
        ((y * dy.to(dev)).sum() + (st * ds.to(dev)).sum()).backward()
        grads[dev] = [leaf.grad.cpu() for leaf in leaves]
    xerr = max(_held_max(a.cuda(), b.cuda(), torch.float32, f"ssd_chunked grad {p} card vs CPU")
               for a, b, p in zip(grads["cuda"], grads["cpu"], ("x", "dt", "A", "B", "C")))
    emit("kernel", name="ssd_intra_chunk_bwd", cases=len(res), design_by_case=paths,
         bf16_bit_equal_repeat=True, tol_of_max={str(k)[6:]: v for k, v in TOL_BWD_MAX.items()},
         max_abs_err=max(errs["ssd_intra_chunk_bwd"]), max_abs_err_by_case=res,
         ssd_chunked_grads_card_vs_cpu_max_abs_err=xerr)

    res, paths = {}, {}
    for i, (name, B, L, W) in enumerate(RGLRU_BWD_CASES):
        for dtype in DTYPES:
            args, out, dh, dht = rglru_bwd_inputs(B, L, W, dtype, seed=1600 + 10 * i)
            path = RG.rglru_bwd_path(dtype, W)
            paths[f"{name}/{str(dtype)[6:]}"] = path
            check(path == ("vec" if dtype == torch.bfloat16 and W % 8 == 0 else "scalar"),
                  f"rglru_scan_bwd {name} {dtype}: design {path}")
            for tag, gt in (("with_hT", dht), ("h_only", None)):
                before = RG.rglru_scan_bwd.launches
                got = RG.rglru_scan_bwd(*args, out, dh, gt)
                check(RG.rglru_scan_bwd.launches == before + 1,
                      f"rglru_scan_bwd {name}: no launch")
                want = RG.rglru_scan_bwd_plain(*args, out, dh, gt)
                err = max(_held_max(g, w, dtype, f"rglru_scan_bwd {name} {tag} {dtype} {p}")
                          for g, w, p in zip(got, want, ("dx", "dr", "di", "dlam", "dh0")))
                if gt is not None:
                    again = RG.rglru_scan_bwd(*args, out, dh, gt)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"rglru_scan_bwd {name} {dtype}: two calls differ")
                    if path == "vec":
                        # the design it replaced, launched by name on the same inputs
                        old_ = RG._rglru_scan_bwd_cuda(*args, out, dh, gt, design="scalar")
                        err = max(err, max(
                            _held_max(g, w, dtype, f"rglru_scan_bwd {name} scalar {p}")
                            for g, w, p in zip(old_, want, ("dx", "dr", "di", "dlam", "dh0"))))
                errs["rglru_scan_bwd"].append(err)
                res[f"{name}/{tag}/{str(dtype)[6:]}"] = err
    emit("kernel", name="rglru_scan_bwd", cases=len(res), design_by_case=paths,
         bit_equal_repeat=True,
         tol_of_max={str(k)[6:]: v for k, v in TOL_BWD_MAX.items()},
         max_abs_err=max(errs["rglru_scan_bwd"]), max_abs_err_by_case=res)


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
    _zero_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = time.perf_counter()
        reports = run(spec, seeds=seeds, backend="soa", fallback=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = _counts()
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
        # one fused launch per allocation: Phase A, Phase B and Phase B's
        # start validation; the standalone grant and every other kernel
        # never run on this path
        want = dict.fromkeys(COUNTED, 0)
        want["alloc_ladder"] = 3 * rounds
        check(rounds == (1 + retries) * problem.const["t0"].shape[0],
              f"{tag}: {rounds} rounds for {retries} retries")
        check(launches == want, f"{tag}: launches {launches}, want {want}")
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


def _per_launch_ms(by_name, tags):
    """Device ms per call of the kernels named by ``tags`` (a substring,
    or a tuple whose first entry counts the calls)."""
    tags = (tags,) if isinstance(tags, str) else tags
    n = sum(v[0] for k, v in by_name.items() if tags[0] in k)
    tot = sum(v[1] for k, v in by_name.items() if any(t in k for t in tags))
    return (tot / n / 1e3) if n else None


_SETTLED = set()  # cells whose window a full run of this process settled


def _profile_problem(policy, n_rounds):
    """The first ``n_rounds`` rounds of the main path's problem for
    ``policy`` (R=1024, the window the runner settled on) and its lanes."""
    spec = main_spec(policy)
    wf, model, _s, _p = runner._prepare_run(spec)
    dur = spec.scenario.duration_s
    key = (build_skeleton(wf, spec.scenario, dur).key, policy, spec.drop_policy, float(dur))
    if key not in runner._SOA_LIFE_PAD_HINT and key not in _SETTLED:
        # the runner settles the window (its overflow retry) on a full run
        # of the cell; ``main`` has made ads_tile's, this makes the others'
        _SETTLED.add(key)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run(spec, seeds=list(range(MAIN_R)), backend="soa", fallback=False,
                device="cuda")
    prob = main_problem(spec, MAIN_R)
    const = dict(prob.const)
    for k in ("t0", "t1", "seg", "lo", "entry", "perm", "iperm"):
        const[k] = const[k][:n_rounds]
    bt = sample_trace_batch(build_skeleton(wf, spec.scenario, prob.duration), model,
                            spec.scenario, list(range(MAIN_R)), device="cuda")
    return prob, const, soa._lanes(prob, bt)


def _recording(every):
    """Patch the fused kernel's launchers to keep a copy of the operands of
    every ``every``-th call (the launch itself runs as always); returns the
    list and an undo."""
    seen, orig = [], (K._edf_alloc_ladder_cuda, K._edf_start_keep_cuda)
    n = [0]

    def keep(kind, fn):
        def wrapped(*a):
            if n[0] % every == 0:
                seen.append((kind, [x.clone() if torch.is_tensor(x) else x for x in a]))
            n[0] += 1
            return fn(*a)
        return wrapped

    K._edf_alloc_ladder_cuda = keep("alloc", orig[0])
    K._edf_start_keep_cuda = keep("keep", orig[1])

    def undo():
        K._edf_alloc_ladder_cuda, K._edf_start_keep_cuda = orig
    return seen, undo


def _replay_equal(seen):
    """Each recorded call through the kernel and the plain version: equal."""
    for kind, a in seen:
        if kind == "alloc":
            got, want = K._edf_alloc_ladder_cuda(*a), K._edf_alloc_ladder(*a)
        else:
            got, want = K._edf_start_keep_cuda(*a), K._edf_start_keep(*a)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"alloc_ladder on the main path's {kind} call")
    return len(seen)


def _largest_tensors(cfg, const, lanes, n_rounds=20):
    """Run ``n_rounds`` rounds under a dispatch mode that sees every op's
    output: (largest numel, shapes ending in (W, W))."""
    from torch.utils._python_dispatch import TorchDispatchMode

    W = cfg.W

    class Watch(TorchDispatchMode):
        biggest, square = 0, set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if torch.is_tensor(t):
                    Watch.biggest = max(Watch.biggest, t.numel())
                    if t.dim() >= 2 and tuple(t.shape[-2:]) == (W, W):
                        Watch.square.add(tuple(t.shape))
            return out

    c = dict(const)
    for k in ("t0", "t1", "seg", "lo", "entry", "perm", "iperm"):
        c[k] = c[k][:n_rounds]
    with Watch():
        K.simulate(cfg, c, lanes, device="cuda")
    torch.cuda.synchronize()
    return Watch.biggest, sorted(Watch.square)


def phase_profile():
    """The round loop of the main path's problem (R=1024, same window) for
    ads_tile and tp_driven, first 100 rounds: wall ms, device kernels per
    round, busy ms and idle share (torch.profiler), the fused allocator's
    device ms per launch, the loop's peak device memory; every 10th
    allocation replayed through kernel and plain version (equal); and no
    op output of (R, W, W) shape on the card path."""
    from torch.profiler import ProfilerActivity, profile

    n_rounds = 100
    out = {}
    for policy in ("ads_tile", "tp_driven"):
        prob, const, lanes = _profile_problem(policy, n_rounds)
        cfg = prob.cfg
        seen, undo = _recording(10)
        try:
            K.simulate(cfg, const, lanes, device="cuda")  # warm-up, recorded
        finally:
            undo()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        K.simulate(cfg, const, lanes, device="cuda")
        torch.cuda.synchronize()
        plain_us = 1e6 * (time.perf_counter() - t)
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        before = K.edf_alloc_ladder.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            K.simulate(cfg, const, lanes, device="cuda")
            torch.cuda.synchronize()
            prof_us = 1e6 * (time.perf_counter() - t)
        per_round = (K.edf_alloc_ladder.launches - before) / n_rounds
        check(per_round == (3 if policy == "ads_tile" else 1),
              f"profile {policy}: {per_round} fused launches per round")
        n_kern, busy, by_name = _device_kernels(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        n_equal = _replay_equal(seen)
        biggest, square = _largest_tensors(cfg, const, lanes)
        check(not square, f"profile {policy}: (R, W, W) tensors on the card path: {square}")
        check(biggest < MAIN_R * cfg.W * cfg.W,
              f"profile {policy}: a tensor of {biggest} elements on the card path")
        out[policy] = dict(
            W=cfg.W, P=cfg.P, C=cfg.C, alloc_iters=cfg.alloc_iters,
            wall_ms=plain_us / 1e3, wall_ms_profiled=prof_us / 1e3,
            rounds_per_s=n_rounds / (plain_us / 1e6),
            device_kernels=n_kern,
            kernels_per_round=n_kern / n_rounds if n_kern else None,
            device_busy_ms=busy / 1e3 if n_kern else None,
            device_idle_share=(1.0 - busy / plain_us) if n_kern else None,
            alloc_ladder_per_round=per_round,
            alloc_ladder_device_ms=_per_launch_ms(by_name, "alloc_ladder_kernel"),
            loop_peak_mb=peak_mb,
            rww_mask_mb=MAIN_R * cfg.W * cfg.W * 4 / 1e6,
            largest_tensor_numel=biggest,
            replayed_equal=n_equal,
            top_device_ms={k[:60]: [v[0], round(v[1] / 1e3, 3)] for k, v in top},
        )
    emit("profile", rounds=n_rounds, R=MAIN_R, **out)


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


#: the lockstep phase: commute x every policy of the SoA backend, seeds 0-7
LOCKSTEP_POLICIES = ("cyc", "cyc_s", "tp_driven", "ads_tile")
LOCKSTEP_SEEDS = list(range(8))
#: the sweep phase: the runner's sweep() at its default drive length
SWEEP = dict(n_scenarios=4, policies=("ads_tile", "tp_driven"))


class _Spy:
    """Counts the lockstep batches ``run()`` starts (``run_batch`` in the
    runner's namespace) while it is installed."""

    def __init__(self):
        self.calls = []
        self._orig = runner.run_batch

    def __enter__(self):
        def counted(sims):
            self.calls.append(len(sims))
            return self._orig(sims)
        runner.run_batch = counted
        return self

    def __exit__(self, *exc):
        runner.run_batch = self._orig


def _digests(reports):
    return [report_digest(r) for r in reports]


def phase_lockstep():
    """``run()`` with no backend goes to the lockstep engine, and its
    reports are the scalar engine's bit for bit; a spec outside the SoA
    support set falls back to lockstep.  Walls are host numbers: both
    engines are host code and launch nothing on the card."""
    res = {}
    for policy in LOCKSTEP_POLICIES:
        spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy)
        _zero_counts()
        with _Spy() as spy:
            t = time.perf_counter()
            got = run(spec, seeds=LOCKSTEP_SEEDS, device="cuda")
            lock_s = time.perf_counter() - t
        check(spy.calls == [len(LOCKSTEP_SEEDS)],
              f"lockstep {policy}: default backend ran batches {spy.calls}")
        check(_counts() == dict.fromkeys(COUNTED, 0),
              f"lockstep {policy}: exact engines launched kernels {_counts()}")
        t = time.perf_counter()
        want = run(spec, seeds=LOCKSTEP_SEEDS, backend="scalar", device="cuda")
        scalar_s = time.perf_counter() - t
        check(_digests(got) == _digests(want), f"lockstep {policy}: digests differ")
        res[policy] = dict(host_lockstep_s=lock_s, host_scalar_s=scalar_s,
                           speedup=scalar_s / lock_s)
    spec = ScenarioSpec(scenario=get_scenario("degraded_commute"), policy="ads_tile")
    check(not runner.soa_usable(spec)[0], "degraded_commute inside the SoA support set")
    with _Spy() as spy:
        got = run(spec, seeds=LOCKSTEP_SEEDS, backend="soa", fallback=True, device="cuda")
    check(spy.calls == [len(LOCKSTEP_SEEDS)], f"SoA fallback ran batches {spy.calls}")
    want = run(spec, seeds=LOCKSTEP_SEEDS, backend="scalar", device="cuda")
    check(_digests(got) == _digests(want), "SoA fallback: digests differ from scalar")
    try:
        run(spec, seeds=LOCKSTEP_SEEDS, backend="soa", fallback=False, device="cuda")
    except soa.SoaUnsupported:
        raised = True
    else:
        raised = False
    check(raised, "fallback=False did not raise SoaUnsupported")
    emit("lockstep", scenario="commute", seeds=len(LOCKSTEP_SEEDS), clock="host",
         fallback="degraded_commute -> lockstep, digests equal scalar", **res)


def _swept(backend, **kw):
    """One sweep in this process (jobs=1, so the launch counters see the
    card's work), with each cell's (spec, report) captured as the runner
    summarises it."""
    cells = []
    orig = runner.summarize

    def capture(spec, report):
        cells.append((spec, report))
        return orig(spec, report)

    runner.summarize = capture
    try:
        _zero_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            t = time.perf_counter()
            rows = sweep(**SWEEP, backend=backend, jobs=1, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = _counts()
    finally:
        runner.summarize = orig
    return rows, cells, launches, wall


def phase_sweep():
    """``sweep()`` on the SoA backend launches the fused allocator on the
    card and agrees with the lockstep sweep of the same cells under the
    equiv phase's gate; campaigns serve repeats from the cache; a
    recorded run exports a valid Chrome trace."""
    rows_s, cells_s, launches, soa_s = _swept("soa", device="cuda")
    check(launches["alloc_ladder"] > 0, f"SoA sweep launched no allocator: {launches}")
    check(launches["ladder_grant"] == 0, f"SoA sweep launched the grant: {launches}")
    rows_l, cells_l, launches_l, lock_s = _swept("lockstep", device="cuda")
    check(launches_l == dict.fromkeys(COUNTED, 0), f"lockstep sweep launched {launches_l}")
    ident = [(r["script"], r["policy"], r["seed"]) for r in rows_l]
    check(len(rows_s) == len(rows_l) == SWEEP["n_scenarios"] * len(SWEEP["policies"]),
          f"sweep rows {len(rows_s)} / {len(rows_l)}")
    check([(r["script"], r["policy"], r["seed"]) for r in rows_s] == ident,
          "SoA and lockstep sweeps ran other cells")
    check([list(r) for r in rows_s] == [list(r) for r in rows_l], "row fields differ")
    check([cell_key(s) for s, _ in cells_s] == [cell_key(s) for s, _ in cells_l],
          "SoA and lockstep sweeps have other cell keys")
    gate = {}
    for policy in SWEEP["policies"]:
        a = [r for s, r in cells_l if s.policy == policy]
        b = [r for s, r in cells_s if s.policy == policy]
        for x, y in zip(a, b):
            check(soa.structural_invariants(x) == soa.structural_invariants(y),
                  f"sweep {policy}: structural invariants")
        ks = soa.ks_statistic(_pooled(a), _pooled(b))
        check(ks <= KS_TOL, f"sweep {policy}: KS {ks}")
        cis = {}
        for metric in ("violation_rate", "realloc_frac"):
            ca = soa.mean_ci([getattr(r, metric) for r in a])
            cb = soa.mean_ci([getattr(r, metric) for r in b])
            check(soa.intervals_overlap(ca, cb, pad=1e-9), f"sweep {policy}: {metric} CI")
            cis[metric] = [ca, cb]
        gate[policy] = dict(ks=ks, ci_lockstep_vs_soa=cis)
    agg_s, agg_l = aggregate_sweep(rows_s), aggregate_sweep(rows_l)
    check(sorted(agg_s) == sorted(agg_l) == sorted(SWEEP["policies"]), "aggregates")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as td:
        campaign = CampaignSpec(name="chip_smoke", n_scenarios=SWEEP["n_scenarios"],
                                policies=SWEEP["policies"], backend="lockstep")
        t = time.perf_counter()
        first = run_campaign(campaign, cache_dir=td, jobs=1, device="cuda")
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        again = run_campaign(campaign, cache_dir=td, jobs=1, device="cuda")
        again_s = time.perf_counter() - t
        check(first.n_executed == len(rows_l) and again.n_executed == 0,
              f"campaign executed {first.n_executed} then {again.n_executed} cells")
        check(again.n_cached == len(rows_l), f"campaign repeat served {again.n_cached}")
        check(first.rows == again.rows == rows_l, "campaign rows differ from the sweep's")
        spec = ScenarioSpec(scenario=get_scenario("rate_churn"), policy="ads_tile")
        rec = TraceRecorder()
        recorded = run(spec, seeds=[0, 1], recorders={1: rec}, device="cuda")
        plain = run(spec, seeds=[0, 1], device="cuda")
        check(_digests(recorded) == _digests(plain), "recorder perturbed the lockstep run")
        check(recorded[1].attribution is not None, "recorded lane has no attribution")
        path = os.path.join(td, "trace.json")
        doc = export_chrome_trace(rec, path)
        with open(path, encoding="utf-8") as fh:
            validate_trace(json.load(fh))
        n_events = len(doc["traceEvents"])
    emit("sweep", n_scenarios=SWEEP["n_scenarios"], policies=list(SWEEP["policies"]),
         soa_launches=launches, host_soa_sweep_s=soa_s, host_lockstep_sweep_s=lock_s,
         gate=gate, campaign=dict(cells=first.n_cells, first_executed=first.n_executed,
                                  first_s=first_s, repeat_executed=again.n_executed,
                                  repeat_s=again_s),
         trace_events=n_events, clock="host")


#: the archs the serve phase drives, in turn, at full width
SERVE_ARCHS = ("granite_moe_1b", "mamba2_2p7b", "recurrentgemma_9b", "gemma3_4b",
               "phi3_vision_4p2b", "musicgen_large", "stablelm_12b", "deepseek_v2_236b",
               "gemma2_27b")
#: archs served at a cut depth: deepseek-v2's 60 layers are 472 GB in
#: bf16, which no single card holds (whole-model serving waits for the
#: sharding of ROADMAP A8); 1 dense and 3 MoE layers at full width are
#: ~25.5 GB
SERVE_LAYERS = {"deepseek-v2-236b": 4}
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
#: (lru, lru, attn) unit and the two trailing LRU blocks.  The later archs
#: likewise, at depths that keep the float32 copy (card and host) and the
#: host's float32 run small: gemma3 two 6-layer (5 local, 1 global)
#: units, gemma2 two (local, global) pairs, deepseek its dense layer and
#: one MoE layer (15 GB of experts in float32)
XCHECK_LAYERS = {"recurrentgemma-9b": 5, "gemma3-4b": 12, "phi-3-vision-4.2b": 8,
                 "musicgen-large": 12, "stablelm-12b": 8, "deepseek-v2-236b": 2,
                 "gemma2-27b": 4}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


#: the launch-counted wrapper of each kernel
COUNTED = {"ladder_grant": K.ladder_grant, "alloc_ladder": K.edf_alloc_ladder,
           "flash_attention": FA.flash_attention,
           "flash_attention_bwd": FA.flash_attention_bwd,
           "moe_gmm": MG.moe_gmm, "moe_gmm_bwd": MG.moe_gmm_bwd,
           "ssd_intra_chunk": SSD.ssd_intra_chunk,
           "ssd_intra_chunk_bwd": SSD.ssd_intra_chunk_bwd,
           "rglru_scan": RG.rglru_scan, "rglru_scan_bwd": RG.rglru_scan_bwd}


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
        # MLA's decode is the absorbed form in plain torch: attention's
        # kernel runs in its prefills only
        want["flash_attention"] = cfg.num_layers * (prefill_calls if cfg.mla else calls)
        if cfg.num_experts:
            want["moe_gmm"] = (cfg.num_layers - cfg.first_dense_layers) * calls
    return want


def _batch(cfg, toks, device, patches=None):
    """The model's input for token ids ``toks`` ((B, S), or (B, K, S) for
    codebooks), with ``patches`` (B, P, D) in front when given."""
    batch = {"tokens": torch.as_tensor(np.asarray(toks, np.int64), device=device)}
    if patches is not None:
        batch["patch_embeds"] = patches.to(device=device, dtype=cfg.torch_dtype)
    return batch


def _greedy_steps(model, params, prompt, steps, device, feed=None, patches=None):
    """Prefill ``prompt`` ((S,), or (K, S) for codebooks) at batch 1, with
    ``patches`` (1, P, D) in front when given, then ``steps`` decode steps;
    each step feeds ``feed[i]`` (teacher forcing) or the last greedy token
    (per codebook).  Returns float32 logits per step and the greedy tokens."""
    cfg = model.cfg
    n_front = 0 if patches is None else patches.shape[1]
    n_prompt = np.shape(prompt)[-1]
    cache = model.init_cache(1, max(SERVE["max_len"], n_front + n_prompt + steps + 1), device)
    out, greedy = [], []
    with torch.inference_mode():
        lg, cache = model.prefill(params, _batch(cfg, np.asarray(prompt)[None], device, patches),
                                  cache)
        for i in range(steps + 1):
            if i:
                nxt = feed[i - 1] if feed is not None else greedy[-1]
                t = np.asarray(nxt).reshape((1, -1, 1) if cfg.num_codebooks else (1, 1))
                lg, cache = model.decode_step(params, _batch(cfg, t, device), cache,
                                              n_front + n_prompt + i - 1)
            out.append(lg[0].float().cpu())
            g = torch.argmax(lg[0], dim=-1)
            greedy.append(g.tolist() if g.dim() else int(g))
    return out, greedy


def _cut_depth(cfg, params, layers):
    """The first ``layers`` layers of a stacked tree (for the hybrid, the
    LRU and attention stacks its shorter pattern needs; a MoE stack's
    leading dense layers first)."""
    cut = dataclasses.replace(cfg, num_layers=layers)
    if cfg.family == "hybrid":
        n_lru, n_att = hybrid_layout(cut)
        stacks = {"lru_layers": n_lru, "attn_layers": n_att}
    elif "dense_layers" in params:
        n_dense = cfg.first_dense_layers
        check(layers > n_dense, f"cut of {cfg.name} to {layers} layers keeps no MoE layer")
        stacks = {"dense_layers": n_dense, "layers": layers - n_dense}
    else:
        stacks = {"layers": layers}
    out = dict(params)
    for key, n in stacks.items():
        out[key] = _map(params[key], lambda a, n=n: a[:n])
    return cut, out


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _record_routes():
    """Record the sorted top-k expert ids of every router call (one per
    MoE layer per engine call) until the returned ``undo`` is called."""
    from repro_torch.models import moe as moe_mod

    rec, orig = [], moe_mod.route

    def route(router, tokens, k):
        gates, ids = orig(router, tokens, k)
        rec.append(torch.sort(ids, dim=-1).values.cpu())
        return gates, ids

    moe_mod.route = route
    return rec, lambda: setattr(moe_mod, "route", orig)


def _routing_check(cfg, params, prompt, tok32, logits32, routes32):
    """The bf16 card run against the float32 card run on the same weights
    and tokens (teacher-forced to the float32 run's greedy tokens): per
    MoE layer, how many (token, choice) expert picks differ, and the
    largest logit difference per step."""
    rec, undo = _record_routes()
    try:
        logits16, _ = _greedy_steps(LM(cfg), params, prompt, XCHECK_STEPS, "cuda",
                                    feed=tok32[:-1])
    finally:
        undo()
    check(len(rec) == len(routes32), "routing check: router calls differ")
    n_layers = cfg.num_layers - cfg.first_dense_layers
    by_layer = [0] * n_layers
    total = 0
    first = None
    for i, (a, b) in enumerate(zip(routes32, rec)):
        total += a.numel()
        diff = sum(len(set(x.tolist()) ^ set(y.tolist())) // 2 for x, y in zip(a, b))
        by_layer[i % n_layers] += diff
        if diff and first is None:
            first = dict(step=i // n_layers, layer=i % n_layers)
    res = dict(arch=cfg.name, steps=1 + XCHECK_STEPS, choices=total,
               choices_differ=sum(by_layer), differ_by_layer=by_layer, first_differ=first,
               max_abs_logit_diff_bf16_vs_f32=[float((a.float() - b).abs().max())
                                               for a, b in zip(logits16, logits32)],
               max_abs_logit_f32=[float(b.abs().max()) for b in logits32])
    emit("serve_routing", **res)
    return res


def _serve_xcheck(cfg, params, prompt, patches=None):
    layers = XCHECK_LAYERS.get(cfg.name)
    if layers and layers < cfg.num_layers:
        cfg, params = _cut_depth(cfg, params, layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = LM(cfg32)
    p32 = _to(params, "cuda", torch.float32)
    routes32, undo = _record_routes() if cfg.num_experts else (None, lambda: None)
    t = time.perf_counter()
    try:
        gpu_logits, gpu_tok = _greedy_steps(model, p32, prompt, XCHECK_STEPS, "cuda",
                                            patches=patches)
    finally:
        undo()
    gpu_s = time.perf_counter() - t
    if cfg.num_experts:
        _routing_check(cfg, params, prompt, gpu_tok, gpu_logits, routes32)
    p32 = _to(p32, "cpu")
    t = time.perf_counter()
    cpu_logits, cpu_tok = _greedy_steps(model, p32, prompt, XCHECK_STEPS, "cpu",
                                        feed=gpu_tok[:-1], patches=patches)
    cpu_s = time.perf_counter() - t
    errs, margins = [], []
    for a, b in zip(gpu_logits, cpu_logits):
        check(bool(torch.isfinite(a).all()), "serve xcheck: non-finite card logits")
        errs.append(float((a - b).abs().max()))
        top2 = torch.topk(b, 2, dim=-1).values
        margins.append(float((top2[..., 0] - top2[..., 1]).min()))
    del p32
    res = dict(arch=cfg.name, layers=cfg.num_layers, dtype="float32",
               patches=0 if patches is None else patches.shape[1],
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


#: kernel -> substrings of its device kernels' names: the first counts
#: the calls, the rest add their time to it (the serve path is bf16: SSD's
#: one tensor-core kernel; RG-LRU's short-L or chunked kernel)
DEVICE_NAMES = {"flash_attention": ("flash_fwd_", "flash_merge_"), "moe_gmm": ("moe_gmm_",),
                "ssd_intra_chunk": ("ssd_mma_kernel",),
                "rglru_scan": ("rglru_",)}


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


#: one long request per recurrent arch after the burst, on the same
#: weights: (prompt length, max_len, the kernel whose long shape it runs).
#: mamba2: 4 chunks of 256; recurrentgemma: a prompt that fills 2032 of
#: its 2048 ring slots without wrapping them in the prefill (ROADMAP C9)
SERVE_LONG = {"mamba2-2.7b": (1024, 1040, "ssd_intra_chunk"),
              "recurrentgemma-9b": (2032, 2048, "rglru_scan"),
              # past the windows: gemma3's 1024 (5 of 6 layers) and
              # gemma2's 4096 (every other layer)
              "gemma3-4b": (2048, 2064, "flash_attention"),
              "gemma2-27b": (4608, 4624, "flash_attention")}


def _serve_long(cfg, params, prompt_len, max_len, kernel):
    """One long request through ``ServingEngine`` (batch 1, 16 new tokens):
    first-token and request latency with the kernel launches asserted, then
    the prefill of a second such request under torch.profiler: its device
    ms and the share of it in ``kernel``'s device kernels."""
    from torch.profiler import ProfilerActivity, profile

    ecfg = EngineConfig(max_batch=1, max_len=max_len)
    rng = np.random.RandomState(2)

    def request(rid, new=SERVE["max_new"]):
        return Request(rid=rid, prompt=rng.randint(0, cfg.vocab_size, (prompt_len,))
                       .astype(np.int32), max_new_tokens=new)

    eng = ServingEngine(cfg, params, ecfg, device="cuda")
    eng.submit(request(-1, 2))   # warm-up: the long shapes' first launches
    eng.run_until_drained()
    req = request(0)
    pre, dec = eng.prefill_calls, eng.decode_calls
    _zero_counts()
    torch.cuda.synchronize()
    req.arrival_s = time.time()
    eng.submit(req)
    eng.run_until_drained()
    torch.cuda.synchronize()
    launches = _counts()
    want = _expected_launches(cfg, eng.prefill_calls - pre, eng.decode_calls - dec)
    check(launches == want, f"serve_long {cfg.name}: launches {launches}, want {want}")
    check(launches[kernel] > 0, f"serve_long {cfg.name}: {kernel} never launched")
    check(len(req.generated) == SERVE["max_new"]
          and all(0 <= t < cfg.vocab_size for t in req.generated),
          f"serve_long {cfg.name}: tokens {req.generated}")

    # the profiler at times drops a few of a window's kernels (one of 46
    # flash kernels of gemma2's 4608-token prefill, once in three runs):
    # such a window is taken once more, with another request
    tag = DEVICE_NAMES[kernel][0]
    for attempt in (1, 2):
        eng.submit(request(attempt))
        _zero_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng._admit()             # the prefill, and nothing else
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t)
        prefill_launches = _counts()[kernel]
        eng.run_until_drained()
        n_kern, busy, by_name = _device_kernels(prof)
        kern_n = sum(v[0] for k, v in by_name.items() if tag in k)
        if kern_n == prefill_launches > 0:
            break
    kern_us = sum(v[1] for k, v in by_name.items() if tag in k)
    total_us = sum(v[1] for v in by_name.values())
    check(kern_n == prefill_launches > 0,
          f"serve_long {cfg.name}: {kern_n} {tag} kernels for {prefill_launches} launches "
          f"in each of two profiled prefills")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    emit("serve_long", arch=cfg.name, prompt_len=prompt_len, max_new=SERVE["max_new"],
         max_len=max_len, first_token_s=req.first_token_s - req.arrival_s,
         latency_s=req.finish_s - req.arrival_s, tokens=len(req.generated),
         launches=launches, kernel=kernel, prefill_launches=prefill_launches,
         prefill_wall_ms_profiled=prefill_ms, prefill_device_kernels=n_kern,
         profiled_prefills=attempt,
         prefill_device_ms=total_us / 1e3, prefill_device_busy_ms=busy / 1e3,
         kernel_device_ms=kern_us / 1e3, kernel_share=kern_us / total_us,
         top_device_ms={k[:60]: [v[0], round(v[1] / 1e3, 4)] for k, v in top})


def _serve_burst(cfg, params, ecfg):
    """The launcher's traffic through ``ServingEngine``: the requests, the
    engine and the launch counts of the run."""
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
    for r in reqs:
        r.arrival_s = time.time()
        engine.submit(r)
    engine.run_until_drained()
    torch.cuda.synchronize()
    return reqs, engine.prefill_calls, engine.decode_calls, _counts()


def _serve_codebooks(cfg, params):
    """The launcher's traffic for musicgen, whose (B, K, S) codebook tokens
    the engine cannot feed (ROADMAP C14): the same requests, a batch of 4
    at a time, through ``LM.prefill`` and ``LM.decode_step`` directly, with
    greedy argmax per codebook.  A request's tokens are its frames of K
    codes."""
    model, K = LM(cfg), cfg.num_codebooks
    B, n_new = SERVE["batch"], SERVE["max_new"]
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, (K, SERVE["prompt_len"]))
                    .astype(np.int32), max_new_tokens=n_new) for i in range(SERVE["requests"])]

    def run(group):
        toks = np.stack([r.prompt for r in group])
        cache = model.init_cache(len(group), SERVE["max_len"], "cuda")
        with torch.inference_mode():
            lg, cache = model.prefill(params, _batch(cfg, toks, "cuda"), cache)
            nxt = torch.argmax(lg, dim=-1)                        # (B, K)
            out = [nxt]
            first = time.time()
            for i in range(n_new - 1):
                lg, cache = model.decode_step(params, {"tokens": nxt[..., None]}, cache,
                                              toks.shape[-1] + i)
                nxt = torch.argmax(lg, dim=-1)
                out.append(nxt)
            frames = torch.stack(out, dim=-1).cpu().numpy()       # (B, K, n_new)
        done = time.time()
        for j, r in enumerate(group):
            r.generated = [frames[j, :, t].tolist() for t in range(n_new)]
            r.first_token_s, r.finish_s = first, done

    run(reqs[:B])                                   # warm-up
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    for r in reqs:
        r.arrival_s = t0
    for g in range(0, len(reqs), B):
        run(reqs[g:g + B])
    torch.cuda.synchronize()
    groups = -(-len(reqs) // B)
    return reqs, groups, groups * (n_new - 1), _counts()


#: phi-3-vision's image request: 576 patch embeddings (random, from a
#: seed) and 16 tokens in one prefill, then 4 decode steps, at batch 1
PATCH_REQUEST = dict(prompt_len=16, decode_steps=4, max_len=640)


def _serve_patches(cfg, params):
    """One image request through ``LM.prefill`` / ``decode_step`` (the
    engine's max_len of 128 cannot hold 576 patches): first-token latency,
    decode step wall, launches asserted.  Returns the patches and prompt,
    which the float32 cross-check takes too."""
    model = LM(cfg)
    n, r = cfg.num_patches, PATCH_REQUEST
    patches = _randn((1, n, cfg.d_model), cfg.torch_dtype, seed=31)
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, (r["prompt_len"],))

    def run():
        cache = model.init_cache(1, r["max_len"], "cuda")
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.prefill(params, _batch(cfg, prompt[None], "cuda", patches), cache)
            tok = torch.argmax(lg, dim=-1)
            first = int(tok[0])
            t1 = time.perf_counter()
            toks = [first]
            for i in range(r["decode_steps"]):
                lg, cache = model.decode_step(params, {"tokens": tok[:, None]}, cache,
                                              n + len(prompt) + i)
                tok = torch.argmax(lg, dim=-1)
                toks.append(int(tok[0]))
            t2 = time.perf_counter()
        return toks, t1 - t0, (t2 - t1) / r["decode_steps"]

    run()                                           # warm-up
    _zero_counts()
    toks, first_s, step_s = run()
    launches = _counts()
    want = _expected_launches(cfg, 1, r["decode_steps"])
    check(launches == want, f"serve_patches: launches {launches}, want {want}")
    check(all(0 <= t < cfg.vocab_size for t in toks), f"serve_patches: tokens {toks}")
    emit("serve_patches", arch=cfg.name, patches=n, prompt_len=len(prompt),
         decode_steps=r["decode_steps"], first_token_s=first_s, decode_step_s=step_s,
         tokens=toks, launches=launches)
    return patches, prompt


def phase_serve(arch):
    cfg = get_config(arch)
    reduced = None
    if cfg.name in SERVE_LAYERS:
        layers = SERVE_LAYERS[cfg.name]
        reduced = dict(num_layers=[cfg.num_layers, layers],
                       why="the full depth does not fit one card (ROADMAP A8)")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weight_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    ecfg = EngineConfig(max_batch=SERVE["batch"], max_len=SERVE["max_len"])

    t0 = time.time()
    if cfg.num_codebooks:
        reqs, prefill_calls, decode_calls, launches = _serve_codebooks(cfg, params)
    else:
        reqs, prefill_calls, decode_calls, launches = _serve_burst(cfg, params, ecfg)
    wall = time.time() - t0

    want = _expected_launches(cfg, prefill_calls, decode_calls)
    check(launches == want, f"serve {arch}: launches {launches}, want {want}")
    toks = [t for r in reqs for t in np.ravel(r.generated)]
    check(all(len(r.generated) == SERVE["max_new"] for r in reqs), "serve: short request")
    check(all(0 <= t < cfg.vocab_size for t in toks), "serve: token outside [0, vocab)")
    lat = np.array([r.finish_s - r.arrival_s for r in reqs])
    ftl = np.array([r.first_token_s - r.arrival_s for r in reqs])
    n_tok = sum(len(r.generated) for r in reqs)
    emit("serve", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers, reduced=reduced,
         through="ServingEngine" if not cfg.num_codebooks else "LM.prefill/decode_step",
         params=int(sum(p.numel() for p in _leaves(params))), weight_bytes=int(weight_bytes),
         init_s=init_s, traffic=SERVE, wall_s=wall, tokens=n_tok,
         codes_per_token=cfg.num_codebooks or 1, tokens_per_s=n_tok / wall,
         latency_p50_s=float(np.percentile(lat, 50)), latency_p99_s=float(np.percentile(lat, 99)),
         first_token_p50_s=float(np.percentile(ftl, 50)),
         first_token_p99_s=float(np.percentile(ftl, 99)),
         prefill_calls=prefill_calls, decode_calls=decode_calls,
         launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    prof = None if cfg.num_codebooks else _serve_profile(cfg, params, ecfg)
    if prof:
        emit("serve_profile", **prof)
    if cfg.name in SERVE_LONG:
        _serve_long(cfg, params, *SERVE_LONG[cfg.name])
    patches = prompt = None
    if cfg.num_patches:
        patches, prompt = _serve_patches(cfg, params)
    if prompt is None:
        prompt = reqs[0].prompt
    _serve_xcheck(cfg, params, prompt, patches)
    res = dict(launches=launches, profile=prof)
    if cfg.num_experts:
        moe = params["layers"]["moe"]
        if cfg.mla:
            # deepseek's experts are 22.6 GB: timed here, on its own weights
            res["moe_timing"] = _moe_deepseek_timing(moe)
        else:
            # the timing phase reuses granite-moe's expert weights (2.4 GB)
            res["moe"] = moe
    emit("serve_peak", arch=cfg.name, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    # the rest of every model is freed before the next one is built
    return res


#: the train phase's traffic: launch/train.py's (batch 8, seq 128), 4 steps
#: and a profiled fifth, at full width in bf16 with remat, random weights
#: from seed 0
TRAIN = dict(batch=8, seq_len=128, steps=4, seed=0)
#: the stacks it trains in turn, each with the depth it is cut to (None:
#: its full depth).  recurrentgemma-9b keeps 12 of its 38 layers (4 units of
#: LRU, LRU, attention): the trainer holds bf16 weights and gradients and
#: float32 AdamW moments, 12 bytes a parameter, so its 9.40 B parameters
#: would take 113 GB before activations, and 12 layers (a 1.05 B embedding
#: and ~0.22 B a layer: ~3.7 B) take ~44 GB
TRAIN_STACKS = (("phi4_mini_3p8b", None), ("granite_moe_1b", None), ("mamba2_2p7b", None),
                ("recurrentgemma_9b", 12))
#: a second traffic per stack: mamba2 at batch 2 x seq 1024 (four chunks of
#: 256), 2 steps, so the gradients through contrib and chunk_decay (the
#: inter-chunk scan) run on the card
TRAIN_LONG = {"mamba2-2.7b": dict(batch=2, seq_len=1024, steps=2)}
#: card vs CPU, one step's loss and gradients at full width, cut to 2
#: layers (the hybrid to one unit of 3) and a batch of 2 x 32 tokens (the
#: CPU's float32 copy of a 2-layer phi4-mini is 3.3 GB), float32 on both
#: sides (the card's float32 matmuls in full float32, no TF32): the loss to
#: rtol 1e-5, each gradient leaf to 1e-4 of its largest entry (sums of up
#: to 8192 products in another order, through the layers and a softmax over
#: the vocabulary); a MoE stack's routing must pick the same experts on both
TRAIN_XCHECK = dict(layers=2, batch=2, seq_len=32, loss_rtol=1e-5, grad_rtol=1e-4)
TRAIN_XCHECK_LAYERS = {"recurrentgemma-9b": 3}
#: the save-and-resume check: 2 layers (the hybrid 3) at full width in
#: bf16, batch 2 x 32; the resumed step's loss must equal the uninterrupted
#: run's bit for bit (no kernel of the step reduces with atomics)
TRAIN_RESUME = dict(layers=2, batch=2, seq_len=32)
#: the stacks whose random init gives near-uniform logits: their first
#: loss must lie within half of log(V) of log(V).  recurrentgemma-9b's does
#: not (its first loss at depth 12 was 24.73 against log(V) = 12.45 on an
#: H100, while its reduced config's is 5.58 against 4.85 on the CPU); its
#: step is held by the float32 card-vs-CPU check alone
TRAIN_LOSS0_NEAR_LOG_V = ("phi4-mini-3.8b", "granite-moe-1b-a400m", "mamba2-2.7b")
#: kernel -> its backward kernel
BWD_OF = {"flash_attention": "flash_attention_bwd", "moe_gmm": "moe_gmm_bwd",
          "ssd_intra_chunk": "ssd_intra_chunk_bwd", "rglru_scan": "rglru_scan_bwd"}
#: counted kernel -> substrings of its device kernels' names in a train
#: step: the first counts the calls (one device kernel per call), the rest
#: add their time (bf16 at seq 128: SSD's tensor-core forward and backward,
#: RG-LRU's chunked forward and vectorised backward)
TRAIN_KERNELS = {"flash_attention": ("flash_fwd_", "flash_merge_"),
                 "flash_attention_bwd": ("flash_bwd_delta", "flash_bwd_"),
                 "moe_gmm": ("moe_gmm_",), "moe_gmm_bwd": ("moe_bwd_hidden", "moe_bwd_"),
                 "ssd_intra_chunk": ("ssd_mma_kernel",),
                 "ssd_intra_chunk_bwd": ("ssd_bwd_main_mma_kernel", "ssd_bwd_"),
                 "rglru_scan": ("rglru_chunked_kernel",),
                 "rglru_scan_bwd": ("rglru_bwd_vec_kernel", "rglru_bwd_")}


#: device kernels by class, for the train step's breakdown (first match)
DEVICE_CLASSES = (("flash_attention", ("flash_fwd_", "flash_merge_")),
                  ("flash_attention_bwd", ("flash_bwd_",)),
                  ("moe_gmm_bwd", ("moe_bwd_",)), ("moe_gmm", ("moe_gmm_",)),
                  ("ssd_intra_chunk_bwd", ("ssd_bwd_",)),
                  ("ssd_intra_chunk", ("ssd_mma_kernel", "ssd_cb_kernel", "ssd_chunk_kernel")),
                  ("rglru_scan_bwd", ("rglru_bwd_",)), ("rglru_scan", ("rglru_",)),
                  ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
                  ("reduce", ("reduce_kernel",)),
                  ("index", ("index", "scatter", "gather")),
                  ("elementwise", ("elementwise_kernel",)))


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _grad_probe(params):
    """Hooks that record, for each parameter leaf, whether its gradient is
    finite and nonzero when autograd accumulates it; returns the record
    and the hooks' remover."""
    seen = {}

    def hook(name):
        def fn(p):
            g = p.grad
            seen[name] = (torch.isfinite(g).all(), (g != 0).any(), g.float().abs().max())
        return fn

    handles = [p.register_post_accumulate_grad_hook(hook(n)) for n, p in _named_leaves(params)]
    return seen, lambda: [h.remove() for h in handles]


def _kernel_layers(cfg):
    """Counted kernel -> the layers of ``cfg`` that run it once per forward."""
    if cfg.family == "ssm":
        return {"ssd_intra_chunk": cfg.num_layers}
    if cfg.family == "hybrid":
        n_lru, n_att = hybrid_layout(cfg)
        return {"rglru_scan": n_lru, "flash_attention": n_att}
    out = {"flash_attention": cfg.num_layers}
    if cfg.num_experts:
        out["moe_gmm"] = cfg.num_layers - cfg.first_dense_layers
    return out


def _train_launches(cfg, steps):
    """Kernel launches ``steps`` train steps must make: each forward kernel
    once per layer that runs it, twice under remat (the recompute), its
    backward once; none elsewhere."""
    want = dict.fromkeys(COUNTED, 0)
    for k, n in _kernel_layers(cfg).items():
        want[k] = n * steps * (2 if cfg.remat else 1)
        want[BWD_OF[k]] = n * steps
    return want


def _train_xcheck(cfg):
    """One step's loss and gradients on the card and on the CPU, float32."""
    check(not torch.backends.cuda.matmul.allow_tf32, "float32 matmuls must not use TF32")
    x = TRAIN_XCHECK
    layers = TRAIN_XCHECK_LAYERS.get(cfg.name, x["layers"])
    cut = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = init_params(cut, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(TRAIN["seed"]))
    batch = next(synthetic_stream(cut, DataConfig(batch=x["batch"], seq_len=x["seq_len"]),
                                  device="cpu"))
    out, routes = {}, {}
    for dev in ("cuda", "cpu"):
        p = _map(params, lambda a, dev=dev: a.detach().to(dev).requires_grad_(True))
        rec, undo = _record_routes() if cut.num_experts else ([], lambda: None)
        t = time.perf_counter()
        try:
            loss = train_step_fn(cut)(p, {k: v.to(dev) for k, v in batch.items()})
            loss.backward()
        finally:
            undo()
        out[dev] = (loss.item(), {n: leaf.grad.cpu() for n, leaf in _named_leaves(p)},
                    time.perf_counter() - t)
        routes[dev] = rec
        del p
    del params
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = out["cuda"], out["cpu"]
    differ = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(routes["cuda"], routes["cpu"]))
    rel = {n: float((g_gpu[n] - g_cpu[n]).abs().max() / g_cpu[n].abs().max().clamp(min=1e-30))
           for n in g_cpu}
    res = dict(arch=cfg.name, layers=cut.num_layers, dtype="float32",
               batch=[x["batch"], x["seq_len"]], loss_card=l_gpu, loss_cpu=l_cpu,
               loss_rel_err=abs(l_gpu - l_cpu) / abs(l_cpu),
               grad_rel_err_max=max(rel.values()), grad_rel_err=rel,
               router_calls=len(routes["cuda"]), tokens_routed_otherwise=differ,
               card_s=s_gpu, cpu_s=s_cpu,
               tol={"loss_rtol": x["loss_rtol"], "grad_rtol": x["grad_rtol"]})
    emit("train_xcheck", **res)
    check(len(routes["cuda"]) == len(routes["cpu"]) and differ == 0,
          f"train xcheck {cfg.name}: {differ} tokens routed otherwise on the card")
    check(abs(l_gpu - l_cpu) <= x["loss_rtol"] * abs(l_cpu),
          f"train xcheck {cfg.name}: loss card {l_gpu} vs CPU {l_cpu}")
    check(max(rel.values()) <= x["grad_rtol"],
          f"train xcheck {cfg.name}: gradients differ by {max(rel.values())} of their "
          f"largest entry")
    return res


def _train_resume(cfg):
    """Save at step 1 and resume: the resumed step 2 gives the
    uninterrupted run's loss bit for bit (depth 2, bf16, full width)."""
    import shutil

    r = TRAIN_RESUME
    cut = dataclasses.replace(cfg, num_layers=TRAIN_XCHECK_LAYERS.get(cfg.name, r["layers"]))
    dcfg = DataConfig(batch=r["batch"], seq_len=r["seq_len"])

    def run(steps, ckpt_dir=None, every=1000, resume=False):
        t = Trainer(cut, TrainConfig(steps=steps, log_every=1, checkpoint_every=every,
                                     checkpoint_dir=ckpt_dir), seed=TRAIN["seed"], device="cuda")
        if resume:
            check(t.restore_if_available() and t.step == 1, "train resume: no checkpoint")
        hist = t.fit(synthetic_stream(cut, dcfg, start_step=t.step, device="cuda"))["history"]
        del t
        torch.cuda.empty_cache()
        return {h["step"]: h["loss"] for h in hist}

    with tempfile.TemporaryDirectory() as d:
        full = run(2)
        t0 = time.perf_counter()
        run(1, d, every=1)                        # "crash" after step 1
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        free = shutil.disk_usage(d).free
        t0 = time.perf_counter()
        resumed = run(2, d, resume=True)
        resume_s = time.perf_counter() - t0
    res = dict(arch=cfg.name, layers=cut.num_layers, dtype=cut.dtype, loss_full=full,
               loss_resumed=resumed, bit_equal=resumed[2] == full[2], checkpoint_bytes=nbytes,
               disk_free_bytes=free, crash_run_s=save_s, resume_run_s=resume_s)
    emit("train_resume", **res)
    check(resumed[2] == full[2],
          f"train resume {cfg.name}: step 2 loss {resumed[2]} against {full[2]}")


def _train_profile(trainer, data, cfg):
    """One more step timed plain, then one under the profiler: device busy
    ms, idle share, and each counted kernel's launches (asserted: one step's
    worth) and device ms."""
    from torch.profiler import ProfilerActivity, profile

    trainer.tcfg.steps += 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.fit(data)
    torch.cuda.synchronize()
    plain_us = 1e6 * (time.perf_counter() - t)
    want = _train_launches(cfg, 1)
    # the profiler at times drops kernels from a window (PERF.md section
    # 7): a step whose counts differ is profiled once more
    for attempt in range(2):
        trainer.tcfg.steps += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            trainer.fit(data)
            torch.cuda.synchronize()
            prof_us = 1e6 * (time.perf_counter() - t)
        n_kern, busy, by_name = _device_kernels(prof)
        calls = {k: sum(v[0] for n, v in by_name.items() if tags[0] in n)
                 for k, tags in TRAIN_KERNELS.items()}
        if all(calls[k] == want[k] for k in TRAIN_KERNELS):
            break
    check(n_kern > 0, f"train {cfg.name}: the profiler saw no device kernel")
    check(all(calls[k] == want[k] for k in TRAIN_KERNELS),
          f"train {cfg.name}: profiled step's kernel calls {calls}, want "
          f"{ {k: want[k] for k in TRAIN_KERNELS} }")
    kern_ms = {k: sum(v[1] for n, v in by_name.items() if any(tag in n for tag in tags)) / 1e3
               for k, tags in TRAIN_KERNELS.items() if want[k]}
    by_class = {}
    for n, (cnt, us) in by_name.items():
        c = next((c for c, tags in DEVICE_CLASSES if any(t in n for t in tags)), "other")
        k_, t_ = by_class.get(c, (0, 0.0))
        by_class[c] = (k_ + cnt, t_ + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(profiled_step_wall_ms=prof_us / 1e3, plain_step_wall_ms=plain_us / 1e3,
                profiled_steps=attempt + 1, device_kernels=n_kern, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / plain_us,
                kernel_calls_profiled_step={k: v for k, v in calls.items() if want[k]},
                kernel_device_ms=kern_ms,
                device_ms_by_class={c: [v[0], round(v[1] / 1e3, 4)] for c, v in by_class.items()},
                top_device_ms={k[:160]: [v[0], round(v[1] / 1e3, 4)] for k, v in top})


def _train_traffic(trainer, cfg, batch, seq_len, steps):
    """``steps`` more steps on a fresh stream of ``batch`` x ``seq_len``, every
    launch counter set to 0 just before and read just after (asserted);
    returns the history and the counts."""
    data = synthetic_stream(cfg, DataConfig(batch=batch, seq_len=seq_len), device="cuda")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.tcfg.steps = trainer.step + steps
    hist = trainer.fit(data)["history"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = _train_launches(cfg, steps)
    check(launches == want, f"train {cfg.name}: launches {launches}, want {want}")
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and all(np.isfinite(losses)) and all(np.isfinite(
          [h["grad_norm"] for h in hist])), f"train {cfg.name}: history {hist}")
    return data, hist, launches, wall


def _train_stack(arch, layers):
    """``Trainer`` on one stack at full width: launches, gradients, speed,
    memory, a profiled step, the second traffic where there is one; then
    the float32 card-vs-CPU step and the checkpoint resume."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = Trainer(cfg, TrainConfig(steps=0, log_every=1), seed=TRAIN["seed"], device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for _, p in _named_leaves(trainer.params))
    seen, unhook = _grad_probe(trainer.params)
    steps = TRAIN["steps"]
    # the main path: the counts set to 0 just before, read just after; the
    # probe reads every gradient of the first step
    data = synthetic_stream(cfg, DataConfig(batch=TRAIN["batch"], seq_len=TRAIN["seq_len"]),
                            device="cuda")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.tcfg.steps = 1
    hist = trainer.fit(data)["history"]
    unhook()
    names = [n for n, _ in _named_leaves(trainer.params)]
    check(set(seen) == set(names), f"train {cfg.name}: leaves without a gradient: "
                                   f"{set(names) - set(seen)}")
    bad = [n for n in names if not (bool(seen[n][0]) and bool(seen[n][1]))]
    check(not bad, f"train {cfg.name}: gradients not finite or all zero at step 1: {bad}")
    grad_absmax = {n: float(seen[n][2]) for n in names}
    trainer.tcfg.steps = steps
    hist += trainer.fit(data)["history"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = _train_launches(cfg, steps)
    check(launches == want, f"train {cfg.name}: launches {launches}, want {want}")
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and all(np.isfinite(losses)) and all(np.isfinite(
          [h["grad_norm"] for h in hist])), f"train {cfg.name}: history {hist}")
    check(cfg.name not in TRAIN_LOSS0_NEAR_LOG_V
          or abs(losses[0] - np.log(cfg.vocab_size)) < 0.5 * np.log(cfg.vocab_size),
          f"train {cfg.name}: first loss {losses[0]} far from log(V) = "
          f"{np.log(cfg.vocab_size)}")
    step_ms = [1e3 * h["dt_s"] for h in hist]
    steady = float(np.mean(step_ms[1:]))
    tokens = TRAIN["batch"] * TRAIN["seq_len"]
    peak = torch.cuda.max_memory_allocated()
    res = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
               full_layers=full.num_layers, params=int(n_params), batch=TRAIN["batch"],
               seq_len=TRAIN["seq_len"], steps=steps, remat=cfg.remat, init_s=init_s,
               wall_s=wall, losses=losses, grad_norms=[h["grad_norm"] for h in hist],
               step_ms=step_ms, step_ms_steady=steady, tokens_per_s=tokens / (steady / 1e3),
               peak_mem_gb=peak / 1e9, launches=launches,
               launches_per_step={k: v // steps for k, v in launches.items() if v},
               grad_absmax_min=min(grad_absmax.values()),
               **_train_profile(trainer, data, cfg))
    emit("train", **res)
    long = TRAIN_LONG.get(cfg.name)
    if long:
        torch.cuda.reset_peak_memory_stats()
        _, lh, ll, lwall = _train_traffic(trainer, cfg, long["batch"], long["seq_len"],
                                          long["steps"])
        res["long"] = dict(batch=long["batch"], seq_len=long["seq_len"], launches=ll,
                           losses=[h["loss"] for h in lh],
                           step_ms=[1e3 * h["dt_s"] for h in lh], wall_s=lwall,
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit("train_long", arch=cfg.name, **res["long"])
    del trainer, data
    torch.cuda.empty_cache()
    res["xcheck"] = _train_xcheck(full)
    torch.cuda.empty_cache()
    _train_resume(full)
    torch.cuda.empty_cache()
    return res


def phase_train():
    """Each stack of ``TRAIN_STACKS`` in turn (each freed before the next is
    built): phi4-mini (attention's backward), granite-moe-1b (the MoE
    backward), mamba2-2.7b (SSD's) and recurrentgemma-9b (RG-LRU's and the
    D = 256 attention backward)."""
    return {arch: _train_stack(arch, layers) for arch, layers in TRAIN_STACKS}


# ---------------------------------------------------------------------------
# the mesh, the colocated server and the dry run
# ---------------------------------------------------------------------------
MESH_TRAIN = dict(arch="granite_moe_1b", batch=8, seq_len=128, steps=3, seed=0)


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _mesh_run(cfg, mesh, steps, ckpt_dir=None):
    """``Trainer(cfg, mesh=mesh)`` for ``steps`` steps of the launcher's
    traffic, every launch counter set to 0 just before and read just after."""
    dcfg = DataConfig(batch=MESH_TRAIN["batch"], seq_len=MESH_TRAIN["seq_len"])
    tcfg = TrainConfig(steps=steps, log_every=1, checkpoint_dir=ckpt_dir,
                       checkpoint_every=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()          # another trainer's, if any
    trainer = Trainer(cfg, tcfg, mesh=mesh, seed=MESH_TRAIN["seed"], device="cuda")
    _zero_counts()
    torch.cuda.synchronize()
    hist = trainer.fit(synthetic_stream(cfg, dcfg, device="cuda"))["history"]
    torch.cuda.synchronize()
    return trainer, hist, _counts(), torch.cuda.max_memory_allocated() - held


def phase_mesh_train():
    """``Trainer(mesh=...)`` for granite-moe-1b at full width on a one-rank
    ``(data, model) = (1, 1)`` mesh (NCCL, world size 1; ``ElasticMesh``):
    every placement is whole, so losses and every parameter must equal
    ``Trainer(mesh=None)``'s bit for bit over three steps; then one save on
    the mesh and a restore without it, and the next loss bit-equal."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distribution import ElasticMesh

    cfg = get_config(MESH_TRAIN["arch"])
    steps = MESH_TRAIN["steps"]
    base, base_hist, base_launches, base_peak = _mesh_run(cfg, None, steps)
    ckpt = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = ElasticMesh(model_parallel=1).mesh_for()
        check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"),
              f"mesh_train: mesh {mesh}")
        meshed, hist, launches, peak = _mesh_run(cfg, mesh, steps, ckpt)
        leaves = list(zip(_leaves(base.params), _leaves(meshed.params)))
        check(all(isinstance(b, DTensor) for _, b in leaves), "mesh_train: a plain leaf")
        unequal = sum(not torch.equal(a.detach(), b.full_tensor().detach()) for a, b in leaves)
        del meshed, leaves
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    losses = [h["loss"] for h in hist]
    base_losses = [h["loss"] for h in base_hist]
    check(losses == base_losses, f"mesh_train: losses {losses} against {base_losses}")
    check(unequal == 0, f"mesh_train: {unequal} parameters differ from mesh=None")
    check(launches == base_launches and all(
        launches[k] > 0 for k in ("flash_attention", "flash_attention_bwd", "moe_gmm",
                                  "moe_gmm_bwd")), f"mesh_train: launches {launches} "
          f"against {base_launches}")
    # the same payload resumes without the mesh: step 4 against mesh=None's
    t0 = time.perf_counter()
    resumed = Trainer(cfg, TrainConfig(steps=steps + 1, log_every=1, checkpoint_dir=ckpt),
                      seed=MESH_TRAIN["seed"], device="cuda")
    check(resumed.restore_if_available() and resumed.step == steps, "mesh_train: no checkpoint")
    dcfg = DataConfig(batch=MESH_TRAIN["batch"], seq_len=MESH_TRAIN["seq_len"])
    next_loss = resumed.fit(synthetic_stream(cfg, dcfg, start_step=steps, device="cuda"))
    resume_s = time.perf_counter() - t0
    del resumed
    torch.cuda.empty_cache()
    base.tcfg.steps = steps + 1
    base_next = base.fit(synthetic_stream(cfg, dcfg, start_step=steps, device="cuda"))
    del base
    torch.cuda.empty_cache()
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    shutil.rmtree(ckpt, ignore_errors=True)
    a, b = next_loss["history"][-1]["loss"], base_next["history"][-1]["loss"]
    res = dict(arch=cfg.name, params=cfg.param_count(), dtype=cfg.dtype, mesh=[1, 1],
               batch=MESH_TRAIN["batch"], seq_len=MESH_TRAIN["seq_len"], steps=steps,
               losses=losses, bit_equal=True, launches=launches,
               step_ms=[1e3 * h["dt_s"] for h in hist],
               step_ms_unsharded=[1e3 * h["dt_s"] for h in base_hist],
               peak_mem_gb=peak / 1e9, peak_mem_gb_unsharded=base_peak / 1e9,
               resume_loss=a, resume_loss_unsharded=b, checkpoint_bytes=nbytes,
               resume_s=resume_s)
    emit("mesh_train", **res)
    check(a == b, f"mesh_train: resumed loss {a} against {b}")
    return res


#: ``examples/serve_colocated.py``'s scenario at full width: name, arch,
#: partition, budget_s, downstream_budget_s
COLOCATED = (("perception", "phi4_mini_3p8b", 0, 0.08, 0.05),
             ("planner", "granite_moe_1b", 0, 0.05, 0.0),
             ("cockpit_seg", "gemma3_4b", 1, 0.10, 0.0),
             ("cockpit_depth", "stablelm_12b", 1, 0.10, 0.0))
COLOCATED_RUN = dict(bursts=6, batches=(1, 4), prompt_len=16, seed=0)


def _colocated_model(arch):
    """Full-width weights on the card and one variant per batch size, each
    ending in ``torch.cuda.synchronize()`` so the server times the work;
    estimates from three synchronised warm calls."""
    cfg = get_config(arch)
    model = LM(cfg)
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))

    def fwd(tokens):
        with torch.no_grad():
            x = model.embed(params, {"tokens": tokens})
            x, _ = model.backbone(params, x, positions=torch.arange(x.shape[1], device="cuda"))
            out = model.logits_last(params, x[:, -1])
        torch.cuda.synchronize()
        return out

    variants = {}
    for b in COLOCATED_RUN["batches"]:
        toks = torch.ones((b, COLOCATED_RUN["prompt_len"]), dtype=torch.int32, device="cuda")
        fwd(toks)
        t0 = time.perf_counter()
        for _ in range(3):
            fwd(toks)
        est = (time.perf_counter() - t0) / 3
        variants[f"b{b}"] = ((lambda payload, b=b: fwd(
            torch.as_tensor(payload[:b], device="cuda"))), est)
    return cfg, params, variants


def _colocated_pass(models, cfgs, scale):
    """The example's six chained bursts with every budget and deadline
    times ``scale``; launches counted from 0 around the server's run."""
    from repro_torch.serving import ColocatedServer, ServedModel

    served = {name: ServedModel(name=name, variants=m.variants, partition=m.partition,
                                budget_s=m.budget_s * scale,
                                downstream_budget_s=m.downstream_budget_s * scale)
              for name, m in models.items()}
    server = ColocatedServer(served, num_partitions=2)
    rng = np.random.RandomState(COLOCATED_RUN["seed"])
    for _ in range(COLOCATED_RUN["bursts"]):
        toks = rng.randint(0, 100, (4, COLOCATED_RUN["prompt_len"])).astype(np.int32)

        def chain_cb(_out, toks=toks):
            server.submit("planner", toks, deadline_s=0.15 * scale)

        server.submit("perception", toks, deadline_s=0.25 * scale, done_cb=chain_cb)
        server.submit("cockpit_seg", toks, deadline_s=1.0 * scale)
        server.submit("cockpit_depth", toks, deadline_s=1.0 * scale)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log = server.run(duration_s=60.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    ran = [r for r in log if not r["dropped"]]
    want = dict.fromkeys(COUNTED, 0)
    for r in ran:
        cfg = cfgs[r["model"]]
        want["flash_attention"] += cfg.num_layers
        if cfg.num_experts:
            want["moe_gmm"] += cfg.num_layers - cfg.first_dense_layers
    n_perception = sum(1 for r in ran if r["model"] == "perception")
    check(len(log) == 3 * COLOCATED_RUN["bursts"] + n_perception,
          f"colocated x{scale}: {len(log)} jobs logged")
    check(ran and launches == want, f"colocated x{scale}: launches {launches}, want {want}")
    per_model = {}
    for name in models:
        recs = [r for r in log if r["model"] == name]
        ok = [r for r in recs if not r["dropped"]]
        lat = [1e3 * r["latency_s"] for r in ok]
        per_model[name] = dict(
            arch=cfgs[name].name, jobs=len(recs), ran=len(ok),
            dropped=sum(r["dropped"] for r in recs),
            missed=sum(r["missed"] for r in ok),
            variants={v: sum(r["variant"] == v for r in ok) for v in models[name].variants},
            est_ms={v: 1e3 * e for v, (_, e) in models[name].variants.items()},
            actual_ms=[1e3 * r["actual_s"] for r in ok],
            latency_ms_p50=float(np.percentile(lat, 50)) if lat else None,
            latency_ms_p99=float(np.percentile(lat, 99)) if lat else None)
    return dict(scale=scale, models=per_model, jobs=len(log), wall_s=wall, launches=launches)


def phase_colocated():
    """The colocated server (``serving/colocated.py``, the reference's
    verbatim) holding four full-width models in two partitions, serving
    the example's six chained bursts twice: with its budgets and deadlines
    as they are (set for its reduced models on a CPU: at full width most
    chained planner jobs miss their end-to-end deadline and are dropped by
    the server's rule), and with every budget and deadline times 10, where
    the planner runs too.  Every job runs on the kernels: launches counted
    from 0 around each run and held to one flash forward per attention
    layer per job that ran, one ``moe_gmm`` per MoE layer per planner job."""
    from repro_torch.serving import ServedModel

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models, cfgs, keep = {}, {}, []
    for name, arch, part, budget, down in COLOCATED:
        cfg, params, variants = _colocated_model(arch)
        keep.append(params)
        cfgs[name] = cfg
        models[name] = ServedModel(name=name, variants=variants, partition=part,
                                   budget_s=budget, downstream_budget_s=down)
    setup_s = time.perf_counter() - t0
    weight_gb = sum(p.numel() * p.element_size() for t in keep for p in _leaves(t)) / 1e9
    passes = [_colocated_pass(models, cfgs, scale) for scale in (1, 10)]
    launches = {k: sum(p["launches"][k] for p in passes) for k in COUNTED}
    res = dict(passes=passes, setup_s=setup_s, weight_gb=weight_gb,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    emit("colocated", **res)
    check(passes[-1]["launches"]["moe_gmm"] > 0, "colocated: the planner never ran")
    del models, keep
    torch.cuda.empty_cache()
    return res


#: the two production-mesh cells the card's run traces (the whole sweep:
#: ``python -m repro_torch.launch.dryrun --both-meshes``)
DRYRUN_CELLS = (("granite_moe_1b", "train_4k", False), ("deepseek_v2_236b", "decode_32k", True))


def phase_dryrun():
    """Two cells of the production-mesh dry run, on fake tensors under a
    fake process group of 256 / 512 ranks: status OK, every term finite,
    the card untouched (no allocation, no kernel launch); asked for CUDA,
    it raises."""
    from repro_torch.analysis.roofline import HW
    from repro_torch.launch import dryrun

    try:
        dryrun.run_cell("granite_moe_1b", "train_4k", device="cuda")
        check(False, "dryrun: a CUDA device was accepted")
    except ValueError:
        pass
    cells = []
    for arch, shape, multi in DRYRUN_CELLS:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        _zero_counts()
        t0 = time.perf_counter()
        res = dryrun.run_cell(arch, shape, multi_pod=multi, verbose=False)
        wall = time.perf_counter() - t0
        terms = res["roofline"]
        check(res["status"] == "OK" and all(np.isfinite(terms[k]) for k in (
            "compute_s", "memory_s", "collective_s", "flops_per_device", "bytes_per_device")),
            f"dryrun {arch} {shape}: {res.get('status')}")
        check(torch.cuda.memory_allocated() == mem0 and not any(_counts().values()),
              f"dryrun {arch} {shape} touched the card")
        cells.append(dict(arch=arch, shape=shape, mesh=res["mesh"], chips=res["chips"],
                          wall_s=wall, **{k: terms[k] for k in (
                              "flops_per_device", "bytes_per_device",
                              "collective_bytes_per_device", "collective_breakdown",
                              "compute_s", "memory_s", "collective_s", "dominant",
                              "model_flops_global", "useful_flops_ratio",
                              "roofline_fraction")},
                          collective_ops=res["collective_ops"],
                          argument_bytes_per_device=res["memory"]["argument_bytes_per_device"]))
    res = dict(cells=cells, constants=dict(name=HW.name, peak_flops=HW.peak_flops,
                                           hbm_bw=HW.hbm_bw, link_bw=HW.link_bw,
                                           source="spec sheet, not measured"))
    emit("dryrun", **res)
    return res


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
    host = _host_ms(lambda: K.ladder_grant(limit, cand))
    nbytes = 4 * R * W + 4 * W * C + 4 * R * W        # limit, ladder in; grant out
    nops = 3 * R * W * C                              # add+compare, select, max
    bound_ms, by = _bound(nbytes, nops, F32_OPS_PER_S)
    emit("timing", name="ladder_grant", R=R, W=W, C=C, ms_runs=[ms, ms2],
         host_ms_per_call=host, plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes,
         ops=nops)
    return {"name": "ladder_grant", "route": "cuda",
            "source": "src/repro_torch/csrc/ladder_grant.cu",
            "replaces": "src/repro/core/sim/soa_kernels.py:178",
            "launches": int(launches), "max_abs_err": max(errs["ladder_grant"]),
            "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def _host_ms(fn, iters=2000):
    """Host milliseconds per call: the enqueue rate of back-to-back calls
    (the card keeps up with a launch this small, so this is the wrapper's
    and the launch's host time)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return host


def _alloc_ops(a):
    """Operations the data of one allocation call needs: per lane, the
    fixed-point steps until one changes nothing (the kernel's early exit,
    at most 1 + alloc_iters), each over W entries of one scan add, a
    subtract, a min and a compare-select per rung (2C + 3)."""
    want, entry, part, cand, cap, perm, iters, _bump = a
    R, W = want.shape
    C = cand.shape[-1]
    want_s = torch.where(entry, want, 0.0).index_select(1, perm)
    entry_s = entry.index_select(1, perm)
    excl, _, capg = K._class_prefix(cap.shape[-1], part.expand(R, W).index_select(1, perm),
                                    cap.expand(R, -1))
    cand_s = cand.index_select(-2, perm)
    cur, active = want_s, torch.ones(R, dtype=torch.bool, device=want.device)
    steps = torch.zeros(R, device=want.device)
    for _ in range(1 + iters):
        new = torch.where(entry_s, K._ladder_grant(torch.minimum(want_s, capg - excl(cur)),
                                                   cand_s), 0.0)
        steps += active
        active &= (new != cur).any(dim=1)
        cur = new
    return int(steps.sum()) * W * (2 * C + 3), int(steps.sum())


def _alloc_timing(launches, errs):
    """The fused allocator on a Phase B call of the main path (the last of
    30 recorded rounds: per-lane partitions, the full pool)."""
    prob, const, lanes = _profile_problem("ads_tile", 30)
    seen, undo = _recording(1)
    try:
        K.simulate(prob.cfg, const, lanes, device="cuda")
    finally:
        undo()
    a = [args for kind, args in seen if kind == "alloc" and args[2].shape[0] == MAIN_R][-1]
    want, entry, part, cand, cap, perm, iters, bump = a
    R, W, C, P = *want.shape, cand.shape[-1], cap.shape[-1]
    got, plain = K._edf_alloc_ladder_cuda(*a), K._edf_alloc_ladder(*a)
    torch.cuda.synchronize()
    errs["alloc_ladder"].append(float((got - plain).abs().max()))
    check(torch.equal(got, plain), "alloc_ladder at the main path's Phase B call")

    def call():
        return K.edf_alloc_ladder(want, entry, part, cand, cap, perm,
                                  alloc_iters=iters, bump_passes=bump)

    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: K._edf_alloc_ladder(*a), iters=50, warmup=5)
    ms2 = cuda_ms(call)
    dev_ms = device_ms(call)
    host = _host_ms(call)
    nbytes = (4 * R * W + R * W + 4 * part.shape[0] * W + 4 * cand.numel()
              + 4 * cap.shape[0] * P + 8 * W + 4 * R * W)
    nops, steps = _alloc_ops(a)
    bound_ms, by = _bound(nbytes, nops, F32_OPS_PER_S)
    emit("timing", name="alloc_ladder", call="ads Phase B", R=R, W=W, C=C, P=P,
         alloc_iters=iters, ms_runs=[ms, ms2], device_ms=dev_ms, host_ms_per_call=host,
         plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes, ops=nops,
         lane_steps=steps)
    return {"name": "alloc_ladder", "route": "cuda",
            "source": "src/repro_torch/csrc/ladder_grant.cu",
            "replaces": "src/repro/core/sim/soa_kernels.py:178",
            "launches": int(launches), "max_abs_err": max(errs["alloc_ladder"]),
            "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None, "device_ms": dev_ms,
            "host_ms_per_call": host}


def _sdpa(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call with
    the same mask (GQA through ``enable_gqa``)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def device_ms(fn, iters=20):
    """Device milliseconds per call: the summed duration of every CUDA
    kernel ``iters`` calls launch, under torch.profiler.  A window in which
    the profiler records no kernel at all (2 of ~30 windows in one run)
    is taken once more; None if that one records none either."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, _busy, by_name = _device_kernels(prof)
        if n:
            return sum(v[1] for v in by_name.values()) / iters / 1e3
    return None


def device_ms_by_kernel(fn, iters=5, per_call=None):
    """Device ms per call of each CUDA kernel ``fn`` launches (by its name
    cut to the kernel and its template arguments), under torch.profiler.
    With ``per_call`` (the kernels one call launches) a window that records
    another count is taken again, up to three windows (the profiler at times
    records a fraction of a window's kernels, section 7 of PERF.md); empty
    if no window holds the count, or records no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, _busy, by_name = _device_kernels(prof)
        if n and (per_call is None or n == per_call * iters):
            break
    else:
        return {}
    out = {}
    for name, (_n, us) in by_name.items():
        m = re.search(r"(\w+)(<[^()]*>)?\(", name)
        key = (m.group(1) + (m.group(2) or "")) if m else name
        out[key] = out.get(key, 0.0) + us / iters / 1e3
    return out


def device_ms_checked(fn, per_call, iters=5):
    """Device ms per call from a window holding every kernel ``fn``
    launches (``device_ms_by_kernel``), with its split by kernel; (None,
    {}) if no window did."""
    split = device_ms_by_kernel(fn, iters, per_call)
    return (sum(split.values()) if split else None), split


#: the flash timing rows: granite-moe's decode and prefill (D = 64, the
#: kernels-line row is the decode, the call the serve path makes most),
#: recurrentgemma's ring decode and prefill (D = 256, MQA) as it serves,
#: and past its window: a full, wrapped 2048-slot ring at position 3000,
#: and a 2048-token causal prefill (~34 GFLOP)
FLASH_TIMING = [(c, None) for c in FLASH_CASES[:2]] + [
    (("rg_decode_d256", 4, 16, 1, 1, 128, 256, 24, 128, 2048, 0.0), 24),
    (("rg_prefill_d256", 1, 16, 1, 16, 16, 256, 0, 16, 2048, 0.0), None),
    (("rg_decode_d256_ring2048", 4, 16, 1, 1, 2048, 256, 3000, 2048, 2048, 0.0), 3000),
    (("rg_prefill_d256_L2048", 1, 16, 1, 2048, 2048, 256, 0, 2048, 2048, 0.0), None),
    # the widths of the last six archs' serve paths: stablelm (D = 160),
    # the MLA prefill (D = 192, 128 heads), phi-3-vision (D = 96) decoding
    # and its patch prefill
    (("stablelm_prefill_d160", 1, 32, 8, 16, 16, 160, 0, 16, 0, 0.0), None),
    (("stablelm_decode_d160", 4, 32, 8, 1, 128, 160, 23, 24, 0, 0.0), None),
    (("mla_prefill_d192", 1, 128, 128, 16, 16, 192, 0, 16, 0, 0.0), None),
    (("phi3v_decode_d96", 4, 32, 32, 1, 128, 96, 23, 24, 0, 0.0), None),
    (("phi3v_patch_prefill_d96", 1, 32, 32, 592, 592, 96, 0, 592, 0, 0.0), None),
]


def _split_sweep(plan, call):
    """Device ms per call with the key range cut into 1, 2, 4, ... splits
    of whole tiles, the wrapper's plan overridden (what its choice stands
    against)."""
    tiles = plan.keys_per_split * plan.splits // plan.block_keys
    res, real = {}, FA._plan
    for want in (2 ** i for i in range(8)):
        if want > tiles:
            break
        per = -(-tiles // want)
        forced = dataclasses.replace(plan, keys_per_split=per * plan.block_keys,
                                     splits=-(-tiles // per))
        FA._plan = lambda *a, **k: forced
        try:
            res[forced.splits] = device_ms(call)
        finally:
            FA._plan = real
    return res


def _flash_timing(launches, errs):
    out = {}
    for (name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, c), ring_pos in FLASH_TIMING:
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
        long = Lq * Lk > 1 << 20
        n_it, n_plain = (50, 5) if long else (200, 200)
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), iters=n_it)
        plain_ms = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw), iters=n_plain,
                           warmup=2 if long else 20)
        lib_ms = cuda_ms(lambda: _sdpa(q, k, v, mask), iters=n_it)
        ms2 = cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), iters=n_it)
        dev = device_ms(lambda: FA.flash_attention(q, k, v, **kw))
        lib_dev = device_ms(lambda: _sdpa(q, k, v, mask))
        pairs = int(mask.sum()) * B * Hq                 # visible (query, key) pairs
        rows = int(mask.any(dim=0).sum())                # key rows any query sees
        nbytes = 2 * (2 * B * Hq * Lq * D + 2 * B * Hkv * rows * D)  # q, out; visible k, v
        nops = 4 * pairs * D                             # q.k and p.v
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        plan = FA.flash_plan(dt, B, Hq, Hkv, Lq, Lk, D, n_sm=FA._sm_count(q.get_device()),
                             window=w, q_offset=qo, kv_valid_len=kvl, ring=ring_pos is not None)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], device_ms=dev, plain_ms=plain_ms,
                         library_ms=lib_ms, library_device_ms=lib_dev, bound_ms=bound_ms,
                         bound_by=by, bytes=nbytes, ops=nops, splits=plan.splits,
                         blocks=plan.blocks(B, Hkv))
        if plan.splits > 1:
            out[name]["device_ms_by_splits"] = _split_sweep(plan, lambda: FA.flash_attention(
                q, k, v, **kw))
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
            **{k: v for k, v in out.items() if k != "serve_decode"}}


def _flash_bwd_timing(launches, errs):
    """The backward at phi4-mini's train shape (the kernels-line row), at
    2048 tokens, and at granite-moe's and recurrentgemma's train shapes:
    ms per call, device ms (taken twice), plain version, bound, and SDPA's
    backward (``scaled_dot_product_attention`` under autograd, causal, GQA)
    at the same shape; in the same call the design this one replaces on the
    same inputs in bf16, the CUDA cores (``fma``)."""
    import torch.nn.functional as F

    out = {}
    for name, B, Hq, Hkv, Lq, Lk, D, *_ in BWD_CASES[:4]:
        dt = torch.bfloat16
        q, k, v = flash_inputs(B, Hq, Hkv, Lq, Lk, D, dt, seed=950)
        o, lse = FA.flash_attention(q, k, v, return_lse=True)
        dout = _randn(o.shape, dt, seed=951)
        got = FA.flash_attention_bwd(q, k, v, o, lse, dout)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, dout)
        errs["flash_attention_bwd"].append(max(
            _held(g, w, dt, f"flash_attention_bwd timing {name}", TOL_BWD)
            for g, w in zip(got, want)))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        lib = torch.autograd.grad(lo, (ql, kl, vl), dout, retain_graph=True)
        for g, w in zip(got, lib):
            _held(g, w, dt, f"flash_attention_bwd {name} vs SDPA's backward", TOL_BWD_LIB)

        def call(design=None):
            return FA._flash_attention_bwd_cuda(
                q, k, v, o, lse, dout, causal=True, window=0, softcap=0.0, scale=None,
                q_offset=0, kv_offset=0, kv_valid_len=None, design=design)

        def lib_call():
            return torch.autograd.grad(lo, (ql, kl, vl), dout, retain_graph=True)

        long = Lq * Lk > 1 << 20
        n_it, n_dev = (20, 5) if long else (100, 20)
        for g, w in zip(call("fma"), want):     # the replaced design's answer too
            _held(g, w, dt, f"flash_attention_bwd {name} design fma", TOL_BWD)
        ms = cuda_ms(call, iters=n_it, warmup=3)
        plain_ms = cuda_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, dout),
                           iters=5 if long else 20, warmup=2)
        lib_ms = cuda_ms(lib_call, iters=n_it, warmup=3)
        ms2 = cuda_ms(call, iters=n_it, warmup=3)
        plan = FA.flash_bwd_plan(dt, B, Hq, Hkv, Lq, Lk, D)
        # delta, dK/dV and dQ kernels, and the head groups' sum
        dev, split = device_ms_checked(call, 3 + (plan.groups > 1), iters=n_dev)
        dev2, _ = device_ms_checked(call, 3 + (plan.groups > 1), iters=n_dev)
        lib_dev = device_ms(lib_call, iters=n_dev)
        other = {"fma": dict(ms=cuda_ms(lambda: call("fma"), iters=n_it, warmup=3),
                             device_ms=device_ms_checked(lambda: call("fma"), 3,
                                                         iters=n_dev)[0])}
        pairs = B * Hq * Lq * (Lq + 1) // 2            # causal, Lq == Lk
        # q, out, dout in and dq out; k, v in and dk, dv out; lse in
        nbytes = 2 * (4 * B * Hq * Lq * D + 4 * B * Hkv * Lk * D) + 4 * B * Hq * Lq
        nops = 10 * pairs * D        # q.k, dout.v, p^T dout, ds^T q, ds k
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        known = [x for x in (dev, dev2) if x is not None]
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2],
                         device_ms=min(known) if known else None, device_ms_runs=[dev, dev2],
                         plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
                         bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops, path=plan.path,
                         device_ms_by_kernel=split,
                         head_groups=plan.groups, dkdv_blocks=plan.dkdv_blocks(B, Hkv),
                         dq_blocks=plan.dq_blocks(B, Hq), replaced_designs=other)
        if known and other["fma"]["device_ms"] is not None:
            check(min(known) < other["fma"]["device_ms"],
                  f"flash_attention_bwd {name}: the tensor cores ({min(known)} ms) do not beat "
                  f"the CUDA cores ({other['fma']['device_ms']} ms)")
        emit("timing", name="flash_attention_bwd", case=name, dtype="bfloat16",
             q=[B, Hq, Lq, D], kv=[B, Hkv, Lk, D], **out[name])
    d = out["phi4_train"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/common.py:231",
            "launches": int(launches), "max_abs_err": max(errs["flash_attention_bwd"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "device_ms": d["device_ms"], "replaced_designs": d["replaced_designs"],
            "phi4_L2048": out["phi4_L2048"], "granite_train": out["granite_train"],
            "rg_train_d256": out["rg_train_d256"]}


def _bwd_row(name, source, replaces, launches, per_step, errs, out, main):
    """A kernels-line row for a backward kernel from its timing cases (the
    ``main`` case gives the row's numbers; no single PyTorch call computes
    the same gradients, so ``library_ms`` is null)."""
    d = out[main]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(launches), "launches_per_train_step": per_step,
            "max_abs_err": max(errs[name]), "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
            "device_ms": d["device_ms"], "cases": out}


def _timed(fn, plain, n_it=20, n_plain=5):
    """ms per call (two runs, the lower kept), device ms and the plain
    version's ms."""
    ms = cuda_ms(fn, iters=n_it, warmup=3)
    plain_ms = cuda_ms(plain, iters=n_plain, warmup=1)
    ms2 = cuda_ms(fn, iters=n_it, warmup=3)
    return dict(ms=min(ms, ms2), ms_runs=[ms, ms2], device_ms=device_ms(fn, iters=5),
                plain_ms=plain_ms)


def _moe_bwd_timing(launches, per_step, errs):
    """At granite-moe-1b's train shape (the kernels-line row) and deepseek's
    expert shape with C = 8 over 32 experts."""
    out = {}
    for name, E, C, D, Fd in (MOE_BWD_CASES[0], ("deepseek_e32_c8", 32, 8, 5120, 1536)):
        dt_ = torch.bfloat16
        x, wg, wu, wd = moe_inputs(E, C, D, Fd, None, dt_, seed=960)
        dy = _randn((E, C, D), dt_, seed=961)
        args = (x, wg, wu, wd, dy)
        errs["moe_gmm_bwd"].append(max(
            _held_max(g, w, dt_, f"moe_gmm_bwd timing {name}")
            for g, w in zip(MG.moe_gmm_bwd(*args), MG.moe_gmm_bwd_plain(*args))))
        # x, dy in, dx out; wg, wu, wd in, their gradients out
        nbytes = 2 * (3 * E * C * D + 6 * E * D * Fd)
        nops = 16 * E * C * D * Fd      # h, u, g; dx (two); dwg, dwu, dwd
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        # the design this one replaces, on the same inputs in bf16
        fma = lambda: MG._moe_gmm_bwd_cuda(*args, design="fma")  # noqa: E731
        errs["moe_gmm_bwd"].append(max(
            _held_max(g, w, dt_, f"moe_gmm_bwd timing {name} (fma)")
            for g, w in zip(fma(), MG.moe_gmm_bwd_plain(*args))))
        out[name] = dict(**_timed(lambda: MG.moe_gmm_bwd(*args),
                                  lambda: MG.moe_gmm_bwd_plain(*args)),
                         path=MG.moe_bwd_path(dt_, D, Fd),
                         bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops)
        # both designs launch three kernels a call: hidden, dx, dW
        dev, split = device_ms_checked(lambda: MG.moe_gmm_bwd(*args), 3)
        out[name].update(device_ms=dev, device_ms_by_kernel=split)
        out[name]["plain_device_ms"] = device_ms(lambda: MG.moe_gmm_bwd_plain(*args), iters=3)
        out[name]["replaced_designs"] = {"fma": dict(ms=cuda_ms(fma, iters=10, warmup=2),
                                                     device_ms=device_ms_checked(fma, 3)[0])}
        dev, fdev = out[name]["device_ms"], out[name]["replaced_designs"]["fma"]["device_ms"]
        if dev is not None and fdev is not None:
            check(dev < fdev, f"moe_gmm_bwd {name}: the tensor cores ({dev} ms) do not beat "
                              f"the CUDA cores ({fdev} ms)")
        emit("timing", name="moe_gmm_bwd", case=name, dtype="bfloat16", shape=[E, C, D, Fd],
             library_ms=None, **out[name])
        del x, wg, wu, wd, dy, args
    return _bwd_row("moe_gmm_bwd", "src/repro_torch/csrc/moe_gmm_bwd.cu",
                    "src/repro/kernels/moe_gmm.py:35", launches, per_step, errs, out,
                    "granite_train_c320")


#: a buffer past the 50 MB L2, written between calls to time a kernel with
#: its inputs cold (as they arrive in a train step)
_L2_FLUSH = []


def l2_cold_ms(fn, iters=10):
    """Device ms per call with the L2 flushed before each call: CUDA events
    around each call alone, a 256 MB write between calls."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda"))
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for a, b in ev:
        _L2_FLUSH[0].zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def _with_replaced(out, call, old_call, per_call, old_per_call, what):
    """Device ms (warm, by kernel; L2-cold) of ``call`` and of the design it
    replaced, ``old_call``, on the same inputs in this call; the new design
    must beat the old on device ms."""
    dev, split = device_ms_checked(call, per_call)
    out.update(device_ms=dev, device_ms_by_kernel=split, l2_cold_ms=l2_cold_ms(call))
    odev, osplit = device_ms_checked(old_call, old_per_call)
    out["replaced_designs"] = {what: dict(ms=cuda_ms(old_call, iters=10, warmup=2),
                                          device_ms=odev, device_ms_by_kernel=osplit,
                                          l2_cold_ms=l2_cold_ms(old_call, iters=5))}
    return dev, odev


def _ssd_bwd_timing(launches, per_step, errs):
    """At mamba2-2.7b's train shapes: batch 8 x seq 128 (one chunk of 128,
    y's gradient alone, as the step gives it: the kernels-line row) and
    batch 2 x seq 1024 (four chunks of 256, all three gradients); the
    CUDA-core design it replaced timed on the same inputs, warm and with the
    L2 flushed between calls."""
    out = {}
    for (name, B, L, H, P, N, chunk), every in ((SSD_BWD_CASES[0], False),
                                                (SSD_BWD_CASES[1], True)):
        dt_ = torch.bfloat16
        args, grads = ssd_bwd_inputs(B, L, H, P, N, chunk, dt_, seed=970)
        grads = grads if every else (grads[0], None, None)
        errs["ssd_intra_chunk_bwd"].append(max(
            _held_max(g, w, dt_, f"ssd_intra_chunk_bwd timing {name}")
            for g, w in zip(SSD.ssd_intra_chunk_bwd(*args, *grads),
                            SSD.ssd_intra_chunk_bwd_plain(*args, *grads))))
        _, nb, C, _, _ = args[0].shape
        BC = B * nb
        tri = C * (C + 1) // 2
        # in: x, B, C (bf16), dt, A, the given gradients (float32); out: dx,
        # dB, dC (bf16), ddt, dA
        nbytes = (2 * BC * C * (H * P + 2 * N) + 4 * BC * C * H + 4 * H
                  + 4 * BC * C * H * P + (4 * BC * H * (P * N + 1) if every else 0)
                  + 2 * BC * C * (H * P + 2 * N) + 4 * BC * C * H + 4 * H)
        # C B^T, dC and dB's dCB term over the causal pairs; per head dW and
        # W^T dy over them; with dcontrib, G and dB's contrib term
        nops = 2 * BC * (3 * tri * N + H * 2 * tri * P + (2 * H * C * P * N if every else 0))
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        plan = SSD.ssd_bwd_plan(dt_, BC, C, H, P, N, None, every)
        call = lambda: SSD.ssd_intra_chunk_bwd(*args, *grads)  # noqa: E731
        fma = lambda: SSD._ssd_intra_chunk_bwd_cuda(*args, *grads, design="fma")  # noqa: E731
        out[name] = dict(**_timed(call, lambda: SSD.ssd_intra_chunk_bwd_plain(*args, *grads)),
                         grads="dy, dcontrib, ddecay" if every else "dy", path=plan.path,
                         head_groups=plan.groups, bands=plan.bands, smem=plan.smem,
                         bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops)
        # three kernels a call (main, sum, dB / dC); the CUDA-core design eight
        dev, fdev = _with_replaced(out[name], call, fma, 3, 8, "fma")
        if dev is not None and fdev is not None:
            check(dev < fdev, f"ssd_intra_chunk_bwd {name}: the tensor cores ({dev} ms) do not "
                              f"beat the CUDA cores ({fdev} ms)")
        emit("timing", name="ssd_intra_chunk_bwd", case=name, dtype="bfloat16",
             x=list(args[0].shape), N=N, library_ms=None, **out[name])
        del args, grads
    return _bwd_row("ssd_intra_chunk_bwd", "src/repro_torch/csrc/ssd_intra_chunk_bwd.cu",
                    "src/repro/kernels/ssd.py:65", launches, per_step, errs, out,
                    "mamba2_train_L128")


def _rglru_bwd_timing(launches, per_step, errs):
    """At recurrentgemma-9b's train shape (the kernels-line row) and a
    2048-token sequence at its width; the first design timed on the same
    inputs, warm and with the L2 flushed between calls."""
    out = {}
    for name, B, L, W in (RGLRU_BWD_CASES[0], ("L2048_1x2048x4096", 1, 2048, 4096)):
        dt_ = torch.bfloat16
        args, h, dh, dht = rglru_bwd_inputs(B, L, W, dt_, seed=980)
        errs["rglru_scan_bwd"].append(max(
            _held_max(g, w, dt_, f"rglru_scan_bwd timing {name}")
            for g, w in zip(RG.rglru_scan_bwd(*args, h, dh, None),
                            RG.rglru_scan_bwd_plain(*args, h, dh, None))))
        # in: x, r, i (bf16), lam, h0 (bf16), h and dh (float32); out: dx,
        # dr, di (bf16), dlam, dh0
        nbytes = (3 * 2 * B * L * W + 4 * W + 2 * B * W + 2 * 4 * B * L * W
                  + 3 * 2 * B * L * W + 4 * W + 4 * B * W)
        nops = 40 * B * L * W        # the gates again, their chain rule and the scan
        bound_ms, by = _bound(nbytes, nops, F32_OPS_PER_S)
        call = lambda: RG.rglru_scan_bwd(*args, h, dh, None)  # noqa: E731
        old = lambda: RG._rglru_scan_bwd_cuda(*args, h, dh, None, design="scalar")  # noqa: E731
        out[name] = dict(**_timed(call, lambda: RG.rglru_scan_bwd_plain(*args, h, dh, None),
                                  n_plain=2),
                         path=RG.rglru_bwd_path(dt_, W), bound_ms=bound_ms, bound_by=by,
                         bytes=nbytes, ops=nops)
        # two kernels a call in both designs: the scan, dlam's batch sum
        dev, odev = _with_replaced(out[name], call, old, 2, 2, "scalar")
        if dev is not None and odev is not None:
            check(dev < odev, f"rglru_scan_bwd {name}: the vectorised lanes ({dev} ms) do not "
                              f"beat the first design ({odev} ms)")
        emit("timing", name="rglru_scan_bwd", case=name, dtype="bfloat16", x=[B, L, W],
             library_ms=None, **out[name])
        del args, h, dh, dht
    return _bwd_row("rglru_scan_bwd", "src/repro_torch/csrc/rglru_scan_bwd.cu",
                    "src/repro/kernels/rglru.py:47", launches, per_step, errs, out,
                    "rg_train_8x128x4096")


#: the kernel against the float32 references on granite-moe's own expert
#: weights: TOL's bf16 band with its absolute term scaled by the output's
#: rms.  dense_init draws the experts at 1/sqrt(fan_in) with the expert axis
#: as fan_in, so h and u are ~6 and the outputs ~1e2, and where a float32
#: sum of h or u in another order rounds a = bf16(silu(h) u) the other way,
#: an output near 0 moves by more than TOL's 2e-2: the float32 references
#: themselves miss the float64 oracle so (the readings beside each timing
#: row, PERF.md section 6).  The check also holds the float32 references to
#: this band against the oracle, so that it asks no more of the kernel than
#: float32 arithmetic gives.
TOL_MOE_MODEL = dict(rtol=2e-2, atol_rms=2e-2)


def _moe_readings(got, want):
    """How far ``got`` lies from ``want``: max abs difference, the count of
    elements outside TOL (bf16) and outside TOL_MOE_MODEL, and the
    normwise relative difference."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    band = TOL_MOE_MODEL["rtol"] * want.abs() + TOL_MOE_MODEL["atol_rms"] * rms
    tol = TOL[torch.bfloat16]
    return dict(max_abs=float(diff.max()),
                n_out_tol=int((diff > tol["rtol"] * want.abs() + tol["atol"]).sum()),
                n_out_band=int((diff > band).sum()),
                rel_l2=float((got - want).norm() / want.norm()), want_rms=rms)


def _moe_model_check(moe, E, C, D, layers=4):
    """The kernel on granite-moe's own expert weights (layers 0..3): held to
    TOL_MOE_MODEL against ``moe_gmm_plain`` and ``kref.moe_gmm_ref``, and
    the readings of kernel and references against the float64 oracle."""
    out = {k: [] for k in ("kernel_vs_plain", "kernel_vs_ref", "kernel_vs_f64",
                           "plain_vs_f64", "ref_vs_f64")}
    for i in range(layers):
        w = (moe["wg"][i], moe["wu"][i], moe["wd"][i])
        x = _randn((E, C, D), torch.bfloat16, seed=901 + i)
        got = MG.moe_gmm(x, *w)
        plain, ref, o64 = MG.moe_gmm_plain(x, *w), kref.moe_gmm_ref(x, *w), MG.moe_gmm_oracle64(x, *w)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"moe_gmm C={C} layer {i}: non-finite")
        for key, (a, b) in {"kernel_vs_plain": (got, plain), "kernel_vs_ref": (got, ref),
                            "kernel_vs_f64": (got, o64), "plain_vs_f64": (plain, o64),
                            "ref_vs_f64": (ref, o64)}.items():
            out[key].append(_moe_readings(a, b))
    bad = {k: [r["n_out_band"] for r in v] for k, v in out.items() if any(r["n_out_band"] for r in v)}
    check(not bad, f"moe_gmm C={C} on granite's weights: elements outside TOL_MOE_MODEL {bad}")
    return {k: {f: [r[f] for r in v] for f in v[0]} for k, v in out.items()}


def _moe_baseline(path):
    """``moe_gmm`` built from another source of ``csrc/moe_gmm.cu`` (one
    with the same C entry point, such as the parent commit's), for timing
    beside this one; None without ``path``."""
    if not path:
        return None
    import ctypes
    import hashlib

    src = open(path, "rb").read()
    lib_path = os.path.join(_cuda._BUILD_DIR, "baseline",
                            f"libmoe_gmm-{hashlib.sha1(src).hexdigest()[:16]}.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    res = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", lib_path, path],
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"baseline moe_gmm build: {res.stdout[-800:]}{res.stderr[-800:]}")
    lib = ctypes.CDLL(lib_path)
    restype, argtypes = MG._SIG["moe_gmm"]
    lib.moe_gmm.restype, lib.moe_gmm.argtypes = restype, argtypes

    def run(x, wg, wu, wd):
        E, C, D = x.shape
        out = torch.empty_like(x)
        err = lib.moe_gmm(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                          out.data_ptr(), E, C, D, wg.shape[2], MG._DTYPES[x.dtype],
                          torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"baseline moe_gmm launch: CUDA error {err}")
        return out
    return run


def _moe_deepseek_timing(moe):
    """``moe_gmm`` at deepseek-v2's serve shape (E = 160, C = 8, D = 5120,
    F = 1536) on its own expert weights, one MoE layer after another
    (7.55 GB each, cold in L2 at every call): held to TOL_MOE_MODEL against
    the plain version and the float64 oracle on layer 0, then kernel, plain
    version, a plain read of the same weights, and the bound."""
    E, D, Fd = moe["wg"].shape[1:]
    C = max(8, int(1.25 * 6 * SERVE["batch"] / E))       # dispatch's capacity at a decode step
    L = moe["wg"].shape[0]
    x = _randn((E, C, D), torch.bfloat16, seed=911)
    w = (moe["wg"][0], moe["wu"][0], moe["wd"][0])
    got = MG.moe_gmm(x, *w)
    readings = {"kernel_vs_plain": _moe_readings(got, MG.moe_gmm_plain(x, *w)),
                "kernel_vs_f64": _moe_readings(got, MG.moe_gmm_oracle64(x, *w))}
    del got
    bad = {k: r["n_out_band"] for k, r in readings.items() if r["n_out_band"]}
    check(not bad, f"moe_gmm at deepseek's shape: elements outside TOL_MOE_MODEL {bad}")
    it = {"i": 0}

    def cycle(fn):
        def call():
            i = it["i"] = (it["i"] + 1) % L
            return fn(x, moe["wg"][i], moe["wu"][i], moe["wd"][i])
        return call

    def read():
        i = it["i"] = (it["i"] + 1) % L
        return [moe[k][i].sum() for k in ("wg", "wu", "wd")]

    ms = cuda_ms(cycle(MG.moe_gmm), iters=30, warmup=3)
    plain_ms = cuda_ms(cycle(MG.moe_gmm_plain), iters=6, warmup=2)
    ms2 = cuda_ms(cycle(MG.moe_gmm), iters=30, warmup=3)
    dev = device_ms(cycle(MG.moe_gmm), iters=6)
    rd = device_ms(read, iters=6)
    nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)    # x, out; wg, wu, wd
    nops = 2 * E * C * D * Fd * 3
    bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
    wbytes = 2 * 3 * E * D * Fd
    row = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], device_ms=dev, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops,
               weight_tb_per_s=wbytes / (dev * 1e-3) / 1e12 if dev else None,
               read_weights_device_ms=rd,
               read_weights_tb_per_s=wbytes / (rd * 1e-3) / 1e12 if rd else None)
    emit("timing", name="moe_gmm", case="deepseek_serve", dtype="bfloat16", x=[E, C, D],
         F=int(Fd), layers_cycled=L, readings=readings, tol_model=TOL_MOE_MODEL, **row)
    return row


def _moe_timing(moe, launches, errs, baseline=None, deepseek=None):
    """At the serve shape (C = 8) and a 1024-token prefill's (C = 320), on
    the model's own expert weights, one layer after another (2.4 GB in
    all, so every call finds its weights cold in L2, as the serve path
    does).  With ``baseline`` (another build of the kernel) that one is
    timed too, in the order baseline, this, this, baseline."""
    name, E, C, D, Fd, _ = MOE_CASES[0]
    dt = torch.bfloat16
    L = moe["wg"].shape[0]
    out = {}
    for case, C in (("serve", C), ("prefill_c320", 320)):
        readings = _moe_model_check(moe, E, C, D)
        errs["moe_gmm"].append(max(readings["kernel_vs_plain"]["max_abs"]))
        x = _randn((E, C, D), dt, seed=901)
        it = {"i": 0}

        def cycle(fn):
            def call():
                i = it["i"] = (it["i"] + 1) % L
                return fn(x, moe["wg"][i], moe["wu"][i], moe["wd"][i])
            return call

        base = {}
        if baseline is not None:
            w = (moe["wg"][0], moe["wu"][0], moe["wd"][0])
            theirs = baseline(x, *w)
            base["vs_f64"] = _moe_readings(theirs, MG.moe_gmm_oracle64(x, *w))
            check(base["vs_f64"]["n_out_band"] == 0,
                  f"baseline moe_gmm {case} vs the float64 oracle: {base['vs_f64']}")
            # the panels of D change no sum: this build gives the baseline's bits
            base["bit_equal"] = bool(torch.equal(MG.moe_gmm(x, *w), theirs))
            check(base["bit_equal"], f"moe_gmm {case}: output differs from the baseline's")
            base["ms_runs"] = [cuda_ms(cycle(baseline), iters=240, warmup=24)]
        ms = cuda_ms(cycle(MG.moe_gmm), iters=240, warmup=24)
        plain_ms = cuda_ms(cycle(MG.moe_gmm_plain), iters=48, warmup=24)
        ms2 = cuda_ms(cycle(MG.moe_gmm), iters=240, warmup=24)
        dev = device_ms(cycle(MG.moe_gmm), iters=48)
        if baseline is not None:
            base["ms_runs"].append(cuda_ms(cycle(baseline), iters=240, warmup=24))
            base.update(ms=min(base["ms_runs"]), device_ms=device_ms(cycle(baseline), iters=48))
        row = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], device_ms=dev, plain_ms=plain_ms)
        nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)    # x, out; wg, wu, wd
        nops = 2 * E * C * D * Fd * 3
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        row.update(bound_ms=bound_ms, bound_by=by, bytes=nbytes, ops=nops,
                   weight_tb_per_s=2 * 3 * E * D * Fd / (dev * 1e-3) / 1e12 if dev else None)
        if base:
            row["baseline"] = base
        if case == "serve":
            # what a plain read of the same weights reaches: torch's sum of
            # each layer's wg, wu and wd, cycled as above
            def read():
                i = it["i"] = (it["i"] + 1) % L
                return [moe[k][i].sum() for k in ("wg", "wu", "wd")]
            rd = device_ms(read, iters=48)
            row["read_weights_device_ms"] = rd
            row["read_weights_tb_per_s"] = 2 * 3 * E * D * Fd / (rd * 1e-3) / 1e12 if rd else None
        out[case] = row
        emit("timing", name="moe_gmm", case=case, dtype="bfloat16", x=[E, C, D], F=Fd,
             library_ms=None, readings=readings, tol_model=TOL_MOE_MODEL, **row)
    d = out["serve"]
    return {"name": "moe_gmm", "route": "cuda", "source": "src/repro_torch/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:35",
            "launches": int(launches), "max_abs_err": max(errs["moe_gmm"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None, "device_ms": d["device_ms"],
            "prefill_c320": out["prefill_c320"], "deepseek_serve": deepseek}


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
        dev = device_ms(lambda: SSD.ssd_intra_chunk(*args))
        host = _host_ms(lambda: SSD.ssd_intra_chunk(*args), iters=200)
        _, nb, C, _, _ = xc.shape
        BC = B * nb
        tri = C * (C + 1) // 2                          # (t, s <= t) pairs per chunk
        nbytes = (2 * B * L * H * P + 4 * B * L * H + 4 * H + 2 * 2 * B * L * N   # x, dt, A, B, C
                  + 4 * BC * C * H * P + 4 * BC * H * P * N + 4 * BC * H)      # y, contrib, decay
        nops = BC * tri * N * 2 + BC * H * (tri * P * 2 + C * P * N * 2)       # C.B^T, y, contrib
        bound_ms, by = _bound(nbytes, nops, BF16_OPS_PER_S)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], device_ms=dev,
                         host_ms_per_call=host, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=by, bytes=nbytes, ops=nops,
                         path=SSD.ssd_plan(dt_, C, P, N).path)
        emit("timing", name="ssd_intra_chunk", case=name, dtype="bfloat16",
             x=list(xc.shape), N=N, library_ms=None, **out[name])
    d = out["full_L1024"]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd.py:65",
            "launches": int(launches), "max_abs_err": max(errs["ssd_intra_chunk"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None, "device_ms": d["device_ms"],
            "serve_prefill": out["serve_prefill"]}


def _rglru_timing(launches, errs):
    """At recurrentgemma-9b's LRU width: a 2048-token prefill (the
    kernels-line row) and the batch-4 decode step."""
    out = {}
    for name, B, L, W in RGLRU_CASES[2:5]:
        dt_ = torch.bfloat16
        args = rglru_inputs(B, L, W, dt_, seed=903)
        got = RG.rglru_scan(*args)
        errs["rglru_scan"].append(max(_held(g, w, dt_, f"rglru_scan timing {name}")
                                      for g, w in zip(got, RG.rglru_scan_plain(*args))))
        ms = cuda_ms(lambda: RG.rglru_scan(*args), iters=100, warmup=10)
        plain_ms = cuda_ms(lambda: RG.rglru_scan_plain(*args), iters=3 if L > 1 else 100,
                           warmup=1 if L > 1 else 10)
        ms2 = cuda_ms(lambda: RG.rglru_scan(*args), iters=100, warmup=10)
        dev = device_ms(lambda: RG.rglru_scan(*args))
        host = _host_ms(lambda: RG.rglru_scan(*args), iters=200 if L > 1 else 2000)
        nbytes = 3 * 2 * B * L * W + 4 * W + 2 * B * W + 4 * B * L * W + 4 * B * W
        nops = 16 * B * L * W        # gates, exps, sqrt and the update, per element
        bound_ms, by = _bound(nbytes, nops, F32_OPS_PER_S)
        out[name] = dict(ms=min(ms, ms2), ms_runs=[ms, ms2], device_ms=dev,
                         host_ms_per_call=host, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=by, bytes=nbytes, ops=nops)
        emit("timing", name="rglru_scan", case=name, dtype="bfloat16", x=[B, L, W],
             library_ms=None, **out[name])
    d = out["prefill_1x2048x4096"]
    return {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru.py:47",
            "launches": int(launches), "max_abs_err": max(errs["rglru_scan"]),
            "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None, "device_ms": d["device_ms"],
            "decode": out["decode_4x1x4096"]}


#: run in a fresh process with ``repro_torch`` importable from the tree
#: under test: flash_attention's per-call and device ms at the serve shapes
_FLASH_AB_CODE = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as FA
cases = json.loads(sys.argv[1])
out = {}
for name, B, Hq, Hkv, Lq, Lk, D, qo, kvl, w, ring_pos in cases:
    g = torch.Generator(device="cuda").manual_seed(900)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in [(B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)])
    kw = dict(causal=True, window=w, q_offset=qo, kv_valid_len=kvl)
    if ring_pos is not None:
        j = torch.arange(Lk, dtype=torch.int32, device="cuda")
        kw["kv_positions"] = ring_pos - torch.remainder(ring_pos - j, Lk)  # ring_positions
    call = lambda: FA.flash_attention(q, k, v, **kw)
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(400):
        call()
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(40):
            call()
        torch.cuda.synchronize()
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    out[name] = dict(ms=a.elapsed_time(b) / 400, device_ms=dev / 40 / 1e3)
print(json.dumps(out))
"""


def phase_flash_ab(baseline_src):
    """flash_attention at the serve shapes (granite's D = 64 decode and
    prefill, recurrentgemma's D = 256 ring decode) from another tree's
    ``src`` (such as the parent commit's) and from this one, each in a
    fresh process, in the order baseline, this, this, baseline."""
    cases = [list(c[:10]) + [None] for c in FLASH_CASES[:2]] + [
        ["rg_decode_d256", 4, 16, 1, 1, 128, 256, 24, 128, 2048, 24]]
    runs = []
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    for tag, src in (("baseline", baseline_src), ("this", here), ("this", here),
                     ("baseline", baseline_src)):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        res = subprocess.run([sys.executable, "-c", _FLASH_AB_CODE,
                              json.dumps([[c[0], *c[1:]] for c in cases])],
                             capture_output=True, text=True, timeout=600, env=env)
        check(res.returncode == 0, f"flash A/B ({tag}): {res.stderr[-1500:]}")
        runs.append((tag, json.loads(res.stdout.strip().splitlines()[-1])))
    emit("flash_ab", baseline_src=baseline_src, order=[t for t, _ in runs],
         runs=[r for _, r in runs])


#: run in a fresh process with ``repro_torch`` importable from the tree
#: under test: ssd_intra_chunk's and rglru_scan's per-call and device ms at
#: the timing shapes (bf16, the same seeded inputs in every tree)
_SSM_AB_CODE = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import ssd as SSD
cases = json.loads(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(904)
def rand(*shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)
out = {}
for kind, name, shape in cases:
    if kind == "ssd":
        B, nb, C, H, P, N = shape
        args = (rand(B, nb, C, H, P), torch.nn.functional.softplus(rand(B, nb, C, H, dtype=torch.float32)),
                -torch.exp(0.3 * rand(H, dtype=torch.float32)), rand(B, nb, C, N), rand(B, nb, C, N))
        call = lambda: SSD.ssd_intra_chunk(*args)
    else:
        B, L, W = shape
        args = (rand(B, L, W), rand(B, L, W), rand(B, L, W), rand(W, dtype=torch.float32), rand(B, W))
        call = lambda: RG.rglru_scan(*args)
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(200):
        call()
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    out[name] = dict(ms=a.elapsed_time(b) / 200,
                     device_ms=sum(e.time_range.elapsed_us() for e in kern) / 20 / 1e3,
                     device_kernels_per_call=len(kern) / 20)
print(json.dumps(out))
"""

#: the A/B shapes: SSD at mamba2-2.7b's L = 1024 (4 chunks of 256) and its
#: one-chunk serve prefill; RG-LRU at recurrentgemma-9b's 2048-token
#: prefill and its batch-4 decode step
SSM_AB_CASES = [("ssd", "ssd_full_L1024", [1, 4, 256, 80, 64, 128]),
                ("ssd", "ssd_serve_prefill", [1, 1, 16, 80, 64, 128]),
                ("rglru", "rglru_prefill_1x2048x4096", [1, 2048, 4096]),
                ("rglru", "rglru_decode_4x1x4096", [4, 1, 4096])]


def phase_ssm_ab(baseline_src):
    """ssd_intra_chunk and rglru_scan at their long and serve shapes from
    another tree's ``src`` (such as the parent commit's) and from this one,
    each in a fresh process, in the order baseline, this, this, baseline."""
    runs = []
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    for tag, src in (("baseline", baseline_src), ("this", here), ("this", here),
                     ("baseline", baseline_src)):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        res = subprocess.run([sys.executable, "-c", _SSM_AB_CODE, json.dumps(SSM_AB_CASES)],
                             capture_output=True, text=True, timeout=600, env=env)
        check(res.returncode == 0, f"SSM A/B ({tag}): {res.stderr[-1500:]}")
        runs.append((tag, json.loads(res.stdout.strip().splitlines()[-1])))
    emit("ssm_ab", baseline_src=baseline_src, order=[t for t, _ in runs],
         ms={c[1]: [r[c[1]]["ms"] for _, r in runs] for c in SSM_AB_CASES},
         device_ms={c[1]: [r[c[1]]["device_ms"] for _, r in runs] for c in SSM_AB_CASES},
         device_kernels_per_call={c[1]: [r[c[1]]["device_kernels_per_call"] for _, r in runs]
                                  for c in SSM_AB_CASES})


#: run in a fresh process with ``repro_torch`` importable from the tree
#: under test: the SoA main path (commute, cockpit_replicas=4, 1024 seeds)
#: for ads_tile and tp_driven, cold then warm, and a torch.profiler window
#: over the first 100 rounds of the problem the runner settled on
_SOA_AB_CODE = r"""
import json, time, warnings, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.sim import soa, soa_kernels as K
from repro_torch.core.sim.batch import sample_trace_batch
from repro_torch.core.sim.trace import build_skeleton
from repro_torch.obs import metrics
from repro_torch.scenarios import ScenarioSpec, get_scenario, run, runner
R, N_ROUNDS, out = 1024, 100, {}
for policy in ("ads_tile", "tp_driven"):
    spec = ScenarioSpec(scenario=get_scenario("commute"), policy=policy, cockpit_replicas=4)
    res = {}
    for tag in ("cold", "warm"):
        metrics.enable()
        metrics.reset()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            t = time.perf_counter()
            run(spec, seeds=list(range(R)), backend="soa", fallback=False, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        snap = metrics.snapshot()
        metrics.enable(False)
        rounds = snap["counters"].get("soa_rounds", 0)
        res[tag] = dict(wall_s=wall, rounds=rounds,
                        rounds_per_s=rounds / snap["phases"]["soa_loop"]["total_s"])
    wf, model, sched, pf = runner._prepare_run(spec)
    dur = spec.scenario.duration_s
    skel = build_skeleton(wf, spec.scenario, dur)
    pad = runner._SOA_LIFE_PAD_HINT.get((skel.key, policy, spec.drop_policy, float(dur)), 0.0)
    prob = soa.build_problem(wf, model, sched, pf, runner._make_run_policy(spec, pf),
                             spec.scenario, dur, replan=spec.replan, n_lanes=R,
                             drop_policy=spec.drop_policy,
                             options=soa.SoaOptions(life_pad_s=pad))
    const = dict(prob.const)
    for k in ("t0", "t1", "seg", "lo", "entry", "perm", "iperm"):
        const[k] = const[k][:N_ROUNDS]
    lanes = soa._lanes(prob, sample_trace_batch(skel, model, spec.scenario, list(range(R)),
                                                device="cuda"))
    K.simulate(prob.cfg, const, lanes, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    K.simulate(prob.cfg, const, lanes, device="cuda")
    torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.simulate(prob.cfg, const, lanes, device="cuda")
        torch.cuda.synchronize()
    kern = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in kern:
        if b > end:
            busy += b - max(a, end)
            end = b
    res["profile"] = dict(W=prob.cfg.W, rounds=N_ROUNDS, wall_ms=wall_us / 1e3,
                          rounds_per_s=N_ROUNDS / (wall_us / 1e6),
                          kernels_per_round=len(kern) / N_ROUNDS,
                          device_busy_ms=busy / 1e3, device_idle_share=1.0 - busy / wall_us,
                          loop_peak_mb=peak / 1e6)
    out[policy] = res
print(json.dumps(out))
"""


def phase_soa_ab(baseline_src):
    """The SoA main path and its profile from another tree's ``src`` (such
    as the parent commit's) and from this one, each in a fresh process, in
    the order baseline, this, this, baseline: rounds/s, warm wall-clock,
    kernels per round, device busy and idle, the loop's peak memory, for
    ads_tile and tp_driven."""
    runs = []
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    for tag, src in (("baseline", baseline_src), ("this", here), ("this", here),
                     ("baseline", baseline_src)):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        res = subprocess.run([sys.executable, "-c", _SOA_AB_CODE],
                             capture_output=True, text=True, timeout=900, env=env)
        check(res.returncode == 0, f"SoA A/B ({tag}): {res.stderr[-1500:]}")
        runs.append((tag, json.loads(res.stdout.strip().splitlines()[-1])))
        emit("soa_ab_run", tag=tag, **runs[-1][1])
    emit("soa_ab", baseline_src=baseline_src, order=[t for t, _ in runs],
         warm_rounds_per_s={p: [r[p]["warm"]["rounds_per_s"] for _, r in runs]
                            for p in ("ads_tile", "tp_driven")},
         warm_wall_s={p: [r[p]["warm"]["wall_s"] for _, r in runs]
                      for p in ("ads_tile", "tp_driven")},
         kernels_per_round={p: [r[p]["profile"]["kernels_per_round"] for _, r in runs]
                            for p in ("ads_tile", "tp_driven")},
         loop_peak_mb={p: [r[p]["profile"]["loop_peak_mb"] for _, r in runs]
                       for p in ("ads_tile", "tp_driven")})


def phase_timing(problem, soa_launches, serve, errs, moe_baseline=None, train=None,
                 extra=None):
    kernels = []
    if problem is not None:
        kernels.append(_ladder_timing(problem, soa_launches["ladder_grant"], errs))
        kernels.append(_alloc_timing(soa_launches["alloc_ladder"], errs))
    if serve:
        by_arch = {arch: r["launches"] for arch, r in serve.items()}
        total = {k: sum(n[k] for n in by_arch.values()) for k in COUNTED}
        rows = [_flash_timing(total["flash_attention"], errs)]
        if serve.get("granite_moe_1b"):
            deepseek = serve.get("deepseek_v2_236b", {}).get("moe_timing")
            rows.append(_moe_timing(serve["granite_moe_1b"]["moe"], total["moe_gmm"], errs,
                                    _moe_baseline(moe_baseline), deepseek))
        if serve.get("mamba2_2p7b"):
            rows.append(_ssd_timing(total["ssd_intra_chunk"], errs))
        if serve.get("recurrentgemma_9b"):
            rows.append(_rglru_timing(total["rglru_scan"], errs))
        for row in rows:
            row["launches_by_arch"] = {a: n[row["name"]] for a, n in by_arch.items()}
        kernels += rows
    if train:
        # launches: the train main paths' counts, summed over the stacks
        total = {k: sum(r["launches"][k] for r in train.values()) for k in COUNTED}
        per_step = {k: {r["arch"]: r["launches_per_step"][k] for r in train.values()
                        if r["launches_per_step"].get(k)} for k in COUNTED}
        for row in kernels:
            if row["name"] in ("flash_attention", "moe_gmm", "ssd_intra_chunk", "rglru_scan"):
                row["launches_train"] = total[row["name"]]
                row["launches_per_train_step"] = per_step[row["name"]]
        row = _flash_bwd_timing(total["flash_attention_bwd"], errs)
        row["launches_per_train_step"] = per_step["flash_attention_bwd"]
        kernels.append(row)
        kernels.append(_moe_bwd_timing(total["moe_gmm_bwd"], per_step["moe_gmm_bwd"], errs))
        kernels.append(_ssd_bwd_timing(total["ssd_intra_chunk_bwd"],
                                       per_step["ssd_intra_chunk_bwd"], errs))
        kernels.append(_rglru_bwd_timing(total["rglru_scan_bwd"], per_step["rglru_scan_bwd"],
                                         errs))
    # the later paths' own runs (each counted from 0 around its run)
    for path, counts in (extra or {}).items():
        for row in kernels:
            if counts.get(row["name"]):
                row[f"launches_{path}"] = counts[row["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--flash-baseline", default=None, metavar="SRC",
                    help="another tree's src/ (e.g. the parent commit's) whose "
                         "flash_attention is timed beside this one's (phase flash_ab)")
    ap.add_argument("--soa-baseline", default=None, metavar="SRC",
                    help="another tree's src/ (e.g. the parent commit's) whose SoA main "
                         "path and round-loop profile run beside this one's (phase soa_ab)")
    ap.add_argument("--ssm-baseline", default=None, metavar="SRC",
                    help="another tree's src/ (e.g. the parent commit's) whose "
                         "ssd_intra_chunk and rglru_scan are timed beside this one's "
                         "(phase ssm_ab)")
    ap.add_argument("--moe-baseline", default=None, metavar="MOE_GMM_CU",
                    help="another source of csrc/moe_gmm.cu (e.g. the parent commit's) "
                         "to time beside this one in the timing phase")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = phase_device()
    errs = {k: [] for k in (*KERNELS, "alloc_ladder")}
    if "build" in only:
        phase_build()
    if "kernel" in only:
        phase_kernel(errs)
    if "sampler" in only:
        phase_sampler()
    problem, launches = (None, None)
    if "main" in only:
        problem, launches = phase_main()
    if "loop" in only:
        phase_loop()
    if "equiv" in only:
        phase_equiv()
    if "lockstep" in only:
        phase_lockstep()
    if "sweep" in only:
        phase_sweep()
    if "profile" in only:
        phase_profile()
    serve = {}
    if "serve" in only:
        for arch in SERVE_ARCHS:
            serve[arch] = phase_serve(arch)
            torch.cuda.empty_cache()
    train = None
    if "train" in only:
        train = phase_train()
        torch.cuda.empty_cache()
    extra = {}
    if "mesh_train" in only:
        extra["mesh_train"] = phase_mesh_train()["launches"]
        torch.cuda.empty_cache()
    if "colocated" in only:
        extra["colocated"] = phase_colocated()["launches"]
        torch.cuda.empty_cache()
    if "dryrun" in only:
        phase_dryrun()
    if "timing" in only:
        phase_timing(problem, launches, serve, errs, args.moe_baseline, train, extra)
    if args.flash_baseline:
        phase_flash_ab(args.flash_baseline)
    if args.soa_baseline:
        phase_soa_ab(args.soa_baseline)
    if args.ssm_baseline:
        phase_ssm_ab(args.ssm_baseline)
    emit("done", seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
