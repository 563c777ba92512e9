#!/usr/bin/env python3
"""Time variants of the four redesigned backward kernels (attention's
backward, the MoE grouped matmul's, the SSD intra-chunk part's and the
RG-LRU scan's) on one CUDA card.

Builds each kernel's source as it stands and with named edits (each edit
must find its text, so a changed source fails loudly), one ``nvcc`` per
variant started together, swaps each build in for the port's library and
calls the port's own wrapper, bf16 at the train shapes.  Per variant and
shape it prints one JSON line: ms per call by CUDA events (3 runs), device
ms per kernel by torch.profiler, and the max abs error against the plain
version on the same inputs (the gate is chip_smoke.py's); then the card's
name and power limit:

    python3 scripts/bwd_variants.py            # all four kernels
    python3 scripts/bwd_variants.py flash      # or: moe, ssd, rglru

Attention's backward at phi4-mini's train shape, at 2048 tokens,
granite-moe's and recurrentgemma's train shapes:

* ``as_built``;
* ``light_first``: the grids dispatch the causal mask's lightest blocks
  first (the order undone);
* ``qt32_d128``: tiles of 32 query rows in the dK/dV kernel at D <= 128;
* ``qt32_two_blocks_d128``: the same with two blocks an SM (registers
  capped at 128);
* ``kt32_d128``: key tiles of 32 in the dQ kernel at D <= 128.

``moe_gmm_bwd`` at granite-moe-1b's train shape (E 32, C 320, D 1024, F
512) and deepseek-v2's experts at C = 8 over 32 experts:

* ``as_built``; ``stages2``: a 2-stage ring;
* ``nb32``: 32 bucket rows a block above C = 32 (more, smaller blocks);
* ``kw32``: 32-deep k slabs in the hidden and dx kernels (64-byte reads
  along the weights' rows); ``dx_kw64``: 64-deep in the dx kernel at every
  bucket size;
* ``dw_per1``: one column tile per dW block at every C.

``ssd_intra_chunk_bwd`` (the tensor-core design) at mamba2-2.7b's train
shapes, batch 8 x seq 128 (one chunk, dy alone) and batch 2 x seq 1024
(four chunks of 256, all three gradients); the CUDA-core design it replaced
is timed beside it (``fma``):

* ``as_built``; ``groups_half`` / ``groups_double``: half / twice the head
  groups (the plan's target blocks 66 / 264), the same source;
* ``w_single``: W^T rounded once to bf16 (the lo products left out);
* ``one_block_per_sm``: the main kernel's register cap lifted (one block
  an SM at P = 64); ``b_from_global``: the prologue reads B's rows from
  global memory instead of staging them; ``unbalanced``: each warp keeps
  its s-tile whole (a unit's long tile is not split with its partner);
* phases left out (wrong results, for the breakdown): ``no_prologue`` (no
  C.B^T products), ``no_dy_load``, ``no_x_load``, ``no_pairs`` (no per-tile
  work), ``one_head`` (each block's first head only).

``rglru_scan_bwd`` (the vectorised lanes) at recurrentgemma-9b's train
shape (8, 128, 4096) and at (1, 2048, 4096); ``scalar`` is the first design:

* ``as_built``; ``ieee``: IEEE division and square root in the gates;
* ``no_keep``: r and dh read again in pass 3 at L <= 128;
* ``g2_short`` / ``g4_short``: 16 channels x 128 lanes (one step each) /
  32 x 64 (two steps) at L <= 128;
* ``no_keep_3bps`` / ``no_keep_4bps``: no registers kept, three / four
  blocks an SM;
* ``one_block_per_sm``: the register cap lifted.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import _cuda  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402

FLASH_VARIANTS = {
    "as_built": [],
    "light_first": [
        ("const int j0 = blockIdx.z * kRingKeys;",
         "const int j0 = (gridDim.z - 1 - blockIdx.z) * kRingKeys;"),
        ("const int qi0 = (gridDim.z - 1 - blockIdx.z) * kRingRows;",
         "const int qi0 = blockIdx.z * kRingRows;")],
    "qt32_d128": [("launch_ring<128, 64, 64>", "launch_ring<128, 32, 64>")],
    "qt32_two_blocks_d128": [
        ("launch_ring<128, 64, 64>", "launch_ring<128, 32, 64>"),
        ("__launch_bounds__(kRingThreads, 1)\nflash_bwd_dkdv_ring_mma_kernel",
         "__launch_bounds__(kRingThreads, 2)\nflash_bwd_dkdv_ring_mma_kernel")],
    "kt32_d128": [("launch_ring<128, 64, 64>", "launch_ring<128, 64, 32>")],
}
MOE_VARIANTS = {
    "as_built": [],
    "stages2": [("constexpr int kStages = 3;      // cp.async ring",
                 "constexpr int kStages = 2;      // cp.async ring")],
    "nb32": [("  return launch_mma_nb<64>(", "  return launch_mma_nb<32>(")],
    "kw32": [("constexpr int kKW = 64;", "constexpr int kKW = 32;")],
    "dx_kw64": [("return NB > 16 ? 32 : kKW;", "return kKW;")],
    "dw_per1": [("int dw_per(int C) { return C <= kKC ? 8 : 1; }", "int dw_per(int C) { return 1; }")],
}
SSD_VARIANTS = {
    "as_built": [],
    "w_single": [("                mma_bf16_k8(acc[p0 / 8 + e], wl, yb[e]);\n", "")],
    "one_block_per_sm": [("const bool two = !contrib && P <= 64 && 2 * (smem + 1024) <= 228 * 1024;",
                          "const bool two = false;")],
    "b_from_global": [("const int both = stage_b(C, P, N);", "const int both = 0;")],
    "no_prologue": [("          mma_bf16(acc[0], a, b);\n          mma_bf16(acc[1], a, b + 2);\n", "")],
    "no_x_load": [("const bf16* xra = sa < C ? x + (tok0 + sa) * x_rs + h * P : nullptr;",
                   "const bf16* xra = nullptr;"),
                  ("const bf16* xrb = sb < C ? x + (tok0 + sb) * x_rs + h * P : nullptr;",
                   "const bf16* xrb = nullptr;")],
    "one_head": [("for (int h = h_lo; h < h_hi; ++h) {\n    const long long head",
                  "for (int h = h_lo; h < h_lo + 1; ++h) {\n    const long long head")],
    "unbalanced": [("const int al = min(nl, (nl + ns + 1) / 2);", "const int al = nl;")],
    "no_dy_load": [("if (dy != nullptr && it < items && t < C && p < P)",
                    "if (dy == nullptr && it < items && t < C && p < P)")],
    "no_pairs": [("      for (int i = SEG_I0(k); i < SEG_I0(k) + SEG_N(k); ++i) {\n        const int t0 = i * 16;\n        float* cbp",
                  "      for (int i = nt; i < nt; ++i) {\n        const int t0 = i * 16;\n        float* cbp")],
}
#: plan overrides timed on the as-built source: the main kernel's target blocks
SSD_TARGETS = {"groups_half": 66, "groups_double": 264}
RGLRU_VARIANTS = {
    "as_built": [],
    "ieee": [("{ return __fdividef(1.f, 1.f + expf(-x)); }", "{ return 1.f / (1.f + expf(-x)); }"),
             ("const float rb = rsqrtf(v);\n        const float beta = v * rb;",
              "const float beta = sqrtf(v);\n        const float rb = 1.f / beta;")],
    "no_keep": [("err = launch_vec_kernel<8, 4>(", "err = launch_vec_kernel<8, 0>(")],
    "g2_short": [("err = launch_vec_kernel<8, 4>(", "err = launch_vec_kernel<2, 4>(")],
    "g4_short": [("err = launch_vec_kernel<8, 4>(", "err = launch_vec_kernel<4, 4>(")],
    "no_keep_3bps": [("err = launch_vec_kernel<8, 4>(", "err = launch_vec_kernel<8, 0>("),
                     ("__launch_bounds__(kThreads, 2)\nrglru_bwd_vec_kernel",
                      "__launch_bounds__(kThreads, 3)\nrglru_bwd_vec_kernel")],
    "no_keep_4bps": [("err = launch_vec_kernel<8, 4>(", "err = launch_vec_kernel<8, 0>("),
                     ("__launch_bounds__(kThreads, 2)\nrglru_bwd_vec_kernel",
                      "__launch_bounds__(kThreads, 4)\nrglru_bwd_vec_kernel")],
    "one_block_per_sm": [("__launch_bounds__(kThreads, 2)\nrglru_bwd_vec_kernel",
                          "__launch_bounds__(kThreads, 1)\nrglru_bwd_vec_kernel")],
}
#: (name, B, L, H, P, N, chunk, every gradient): SSD_BWD_CASES[:2] of chip_smoke.py
SSD_SHAPES = [("mamba2_train_L128", 8, 128, 80, 64, 128, 256, False),
              ("mamba2_train_L1024", 2, 1024, 80, 64, 128, 256, True)]
#: (name, B, L, W)
RGLRU_SHAPES = [("rg_train_8x128x4096", 8, 128, 4096), ("L2048_1x2048x4096", 1, 2048, 4096)]
#: (name, B, Hq, Hkv, L, D): BWD_CASES[:4] of chip_smoke.py
FLASH_SHAPES = [("phi4_train", 8, 24, 8, 128, 128), ("phi4_L2048", 1, 24, 8, 2048, 128),
                ("granite_train", 8, 16, 8, 128, 64), ("rg_train_d256", 8, 16, 1, 128, 256)]
#: (name, E, C, D, F)
MOE_SHAPES = [("granite_train_c320", 32, 320, 1024, 512), ("deepseek_e32_c8", 32, 8, 5120, 1536)]


def build(kernel, variants, tmp):
    """Every variant of ``csrc/<kernel>.cu`` built into ``tmp`` (the shared
    headers found beside the source); returns name -> loaded library."""
    src_dir = os.path.join(ROOT, "src", "repro_torch", "csrc")
    src = open(os.path.join(src_dir, f"{kernel}.cu")).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{kernel} {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{kernel}_{name}.cu")
        open(cu, "w").write(text)
        procs[name] = subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-I", src_dir, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{kernel} {name}: nvcc failed:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{kernel}_{name}.so"))
    return libs


def use(kernel, lib, sigs):
    """Make ``lib`` the port's library for ``kernel``."""
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _cuda._LIBS[kernel] = lib


def by_kernel(fn, iters=5):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(\w+)(<[^()]*>)?\(", e.name)
        key = (m.group(1) + (m.group(2) or "")) if m else e.name
        out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    return out


def timed(fn, n=20):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / n)
    return runs


def flash(tmp, g):
    libs = build("flash_attention_bwd", FLASH_VARIANTS, tmp)
    for case, B, Hq, Hkv, L, D in FLASH_SHAPES:
        q = torch.randn((B, Hq, L, D), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, Hkv, L, D), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        out, lse = FA.flash_attention(q, k, v, return_lse=True)
        dout = torch.randn(out.shape, generator=g, device="cuda").bfloat16()
        want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        for name, lib in libs.items():
            use("flash_attention_bwd", lib, FA._BWD_SIG)

            def call():
                return FA.flash_attention_bwd(q, k, v, out, lse, dout)

            err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(call(), want))
            split = by_kernel(call)
            print(json.dumps({"kernel": "flash_attention_bwd", "variant": name, "case": case,
                              "q": [B, Hq, L, D], "kv": [B, Hkv, L, D], "dtype": "bfloat16",
                              "ms": timed(call), "device_ms": sum(split.values()),
                              "device_ms_by_kernel": split, "max_abs_err_vs_plain": err}),
                  flush=True)


def moe(tmp, g):
    libs = build("moe_gmm_bwd", MOE_VARIANTS, tmp)
    for case, E, C, D, Fd in MOE_SHAPES:
        x, dy = (torch.randn((E, C, D), generator=g, device="cuda").bfloat16() for _ in range(2))
        wg, wu = (torch.randn((E, D, Fd), generator=g, device="cuda").mul(D ** -0.5).bfloat16()
                  for _ in range(2))
        wd = torch.randn((E, Fd, D), generator=g, device="cuda").mul(Fd ** -0.5).bfloat16()
        want = MG.moe_gmm_bwd_plain(x, wg, wu, wd, dy)
        for name, lib in libs.items():
            use("moe_gmm_bwd", lib, MG._BWD_SIG)

            def call():
                return MG.moe_gmm_bwd(x, wg, wu, wd, dy)

            err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(call(), want))
            split = by_kernel(call)
            print(json.dumps({"kernel": "moe_gmm_bwd", "variant": name, "case": case,
                              "shape": [E, C, D, Fd], "dtype": "bfloat16", "ms": timed(call),
                              "device_ms": sum(split.values()), "device_ms_by_kernel": split,
                              "max_abs_err_vs_plain": err}), flush=True)
        del x, dy, wg, wu, wd, want


def _emit(kernel, name, case, shape, call, want):
    err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(call(), want))
    split = by_kernel(call)
    print(json.dumps({"kernel": kernel, "variant": name, "case": case, "shape": shape,
                      "dtype": "bfloat16", "ms": timed(call),
                      "device_ms": sum(split.values()), "device_ms_by_kernel": split,
                      "max_abs_err_vs_plain": err}), flush=True)


def ssd(tmp, g):
    libs = build("ssd_intra_chunk_bwd", SSD_VARIANTS, tmp)
    F = torch.nn.functional
    for case, B, L, H, P, N, chunk, every in SSD_SHAPES:
        c = min(chunk, L)
        nb = L // c
        x = torch.randn((B, nb, c, H, P), generator=g, device="cuda").bfloat16()
        dt = F.softplus(torch.randn((B, nb, c, H), generator=g, device="cuda"))
        A = -torch.exp(0.3 * torch.randn((H,), generator=g, device="cuda"))
        Bm, Cm = (torch.randn((B, nb, c, N), generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        grads = [torch.randn((B, nb, c, H, P), generator=g, device="cuda"),
                 torch.randn((B, nb, H, P, N), generator=g, device="cuda"),
                 torch.randn((B, nb, H), generator=g, device="cuda")]
        if not every:
            grads[1:] = [None, None]
        args = (x, dt, A, Bm, Cm, *grads)
        want = SSD.ssd_intra_chunk_bwd_plain(*args)
        shape = [B, nb, c, H, P, N]
        for name, lib in libs.items():
            use("ssd_intra_chunk_bwd", lib, SSD._BWD_SIG)
            _emit("ssd_intra_chunk_bwd", name, case, shape,
                  lambda: SSD._ssd_intra_chunk_bwd_cuda(*args, design="mma"), want)
            if name != "as_built":
                continue
            _emit("ssd_intra_chunk_bwd", "fma", case, shape,
                  lambda: SSD._ssd_intra_chunk_bwd_cuda(*args, design="fma"), want)
            for tname, target in SSD_TARGETS.items():
                SSD.SSD_BWD_TARGET_BLOCKS, keep = target, SSD.SSD_BWD_TARGET_BLOCKS
                SSD.ssd_bwd_plan.cache_clear()
                _emit("ssd_intra_chunk_bwd", tname, case, shape,
                      lambda: SSD._ssd_intra_chunk_bwd_cuda(*args, design="mma"), want)
                SSD.SSD_BWD_TARGET_BLOCKS = keep
                SSD.ssd_bwd_plan.cache_clear()
        del x, dt, A, Bm, Cm, grads, args, want


def rglru(tmp, g):
    libs = build("rglru_scan_bwd", RGLRU_VARIANTS, tmp)
    for case, B, L, W in RGLRU_SHAPES:
        x, r, i = (torch.randn((B, L, W), generator=g, device="cuda").bfloat16() for _ in range(3))
        lam = torch.randn((W,), generator=g, device="cuda")
        h0 = torch.randn((B, W), generator=g, device="cuda").bfloat16()
        out, _ = RG.rglru_scan(x, r, i, lam, h0)
        dh = torch.randn((B, L, W), generator=g, device="cuda")
        args = (x, r, i, lam, h0, out, dh, None)
        want = RG.rglru_scan_bwd_plain(*args)
        for name, lib in libs.items():
            use("rglru_scan_bwd", lib, RG._BWD_SIG)
            _emit("rglru_scan_bwd", name, case, [B, L, W],
                  lambda: RG._rglru_scan_bwd_cuda(*args, design="vec"), want)
            if name == "as_built":
                _emit("rglru_scan_bwd", "scalar", case, [B, L, W],
                      lambda: RG._rglru_scan_bwd_cuda(*args, design="scalar"), want)
        del x, r, i, out, dh, args, want


def main():
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    which = sys.argv[1:] or ["flash", "moe", "ssd", "rglru"]
    g = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        for kernel in which:
            {"flash": flash, "moe": moe, "ssd": ssd, "rglru": rglru}[kernel](tmp, g)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
