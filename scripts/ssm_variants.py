#!/usr/bin/env python3
"""Time variants of the recurrent kernels (RG-LRU scan, SSD intra-chunk)
on one CUDA card.

Builds each kernel's source as it stands and with named edits (each edit
must find its text, so a changed source fails loudly), one ``nvcc`` per
variant started together, and times every variant by CUDA events (3 runs
of 100 calls) at its model's long shape, against the kernel's plain
version on the same inputs (max abs error):

    python3 scripts/ssm_variants.py            # both kernels
    python3 scripts/ssm_variants.py rglru      # or: ssd

It prints one JSON line per variant, then the card's name and power limit.
Variants that take out work measure what the rest costs; their outputs
are not the function's.

RG-LRU at recurrentgemma-9b's prefill, (1, 2048, 4096) bf16:

* ``as_built``; ``ieee``: IEEE division and square root in the gates;
* ``one_block``: 4 thread columns x 64 lanes, 4-step load batches, one
  block an SM; ``one_block_ieee``: both (the first chunked form);
* ``no_math``: the gates replaced by two operations;
* ``stream_stores`` / ``stream_loads``: out written with ``__stcs``, the
  inputs read with ``__ldcs``.

SSD at mamba2-2.7b's L = 1024, x (1, 4, 256, 80, 64), N = 128, bf16:

* ``as_built``; ``no_y``: without the y_intra phase; ``no_contrib``:
  without the contrib phase; ``loads_only``: neither.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import _cuda  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402

RG_IEEE = [("return __fdividef(1.f, 1.f + expf(-x));", "return 1.f / (1.f + expf(-x));"),
           ("const float beta = v * rsqrtf(v);", "const float beta = sqrtf(v);")]
RG_ONE_BLOCK = [("constexpr int G = 2, NL = kThreads / G;", "constexpr int G = 4, NL = kThreads / G;"),
                ("constexpr int kBatch = 2;", "constexpr int kBatch = 4;"),
                ("__launch_bounds__(kThreads, 2)\nrglru_chunked_kernel",
                 "__launch_bounds__(kThreads)\nrglru_chunked_kernel")]
RG_NO_MATH = [("""  const float log_a = ncs * sigmoid(rv);
  a = expf(log_a);
  const float v = fmaxf(1.f - expf(2.f * log_a), 1e-12f);
  const float beta = v * rsqrtf(v);  // sqrt(v) within ~2 ulp
  b = beta * sigmoid(iv) * xv;""", "  a = 0.5f * rv;\n  b = xv + iv + ncs;")]
RG_VARIANTS = {
    "as_built": [], "ieee": RG_IEEE, "one_block": RG_ONE_BLOCK,
    "one_block_ieee": RG_ONE_BLOCK + RG_IEEE, "no_math": RG_NO_MATH,
    "stream_stores": [("*reinterpret_cast<float4*>(p + k) = make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);",
                       "__stcs(reinterpret_cast<float4*>(p + k), make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]));")],
    "stream_loads": [("const uint4 u = *reinterpret_cast<const uint4*>(p);",
                      "const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));")],
}
SSD_NO_Y = [("for (int r0 = 0; r0 < nt; r0 += kWarps) {", "for (int r0 = nt; r0 < nt; r0 += kWarps) {")]
SSD_NO_CONTRIB = [("for (int item = warp; item < kMT * groups; item += kWarps) {",
                   "for (int item = kMT * groups; item < kMT * groups; item += kWarps) {")]
SSD_VARIANTS = {"as_built": [], "no_y": SSD_NO_Y, "no_contrib": SSD_NO_CONTRIB,
                "loads_only": SSD_NO_Y + SSD_NO_CONTRIB}


def build(kernel, variants, tmp):
    """Every variant of ``csrc/<kernel>.cu`` built into ``tmp``; returns
    name -> the entry point, its argument types declared."""
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc", f"{kernel}.cu")).read()
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
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sig = (RG._SIG if kernel == "rglru_scan" else SSD._SIG)[kernel]
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{kernel} {name}: nvcc failed:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(os.path.join(tmp, f"{kernel}_{name}.so")), kernel)
        fn.restype, fn.argtypes = sig
        fns[name] = fn
    return fns


def time_variants(kernel, fns, args, outs, wants, shape):
    for name, fn in fns.items():
        for _ in range(20):
            if fn(*args) != 0:
                raise SystemExit(f"{kernel} {name}: launch failed")
        torch.cuda.synchronize()
        err = max(float((o - w).abs().max()) for o, w in zip(outs, wants))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        runs = []
        for _ in range(3):
            a.record()
            for _ in range(100):
                fn(*args)
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) / 100)
        print(json.dumps({"kernel": kernel, "variant": name, "shape": shape, "dtype": "bfloat16",
                          "ms": runs, "max_abs_err_vs_plain": err}), flush=True)


def rglru(tmp, g, stream):
    B, L, W = 1, 2048, 4096
    x, r, i = (torch.randn((B, L, W), generator=g, device="cuda").bfloat16() for _ in range(3))
    lam = torch.randn((W,), generator=g, device="cuda")
    h0 = torch.randn((B, W), generator=g, device="cuda")
    want = RG.rglru_scan_plain(x, r, i, lam, h0)[0]
    out, h_t = torch.empty((B, L, W), device="cuda"), torch.empty((B, W), device="cuda")
    args = (x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(), h0.data_ptr(), 0,
            out.data_ptr(), h_t.data_ptr(), B, L, W, 1, stream)
    time_variants("rglru_scan", build("rglru_scan", RG_VARIANTS, tmp), args, [out], [want],
                  [B, L, W])


def ssd(tmp, g, stream):
    B, nb, C, H, P, N = 1, 4, 256, 80, 64, 128
    x = torch.randn((B, nb, C, H, P), generator=g, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((B, nb, C, H), generator=g, device="cuda"))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g, device="cuda"))
    Bm, Cm = (torch.randn((B, nb, C, N), generator=g, device="cuda").bfloat16() for _ in range(2))
    wants = SSD.ssd_intra_chunk_plain(x, dt, A, Bm, Cm)
    outs = [torch.empty(w.shape, device="cuda") for w in wants]
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), None,
            *(t.data_ptr() for t in outs), B * nb, C, H, P, N, H * P, N, N, 1, 1,
            SSD.ssd_plan(torch.bfloat16, C, P, N).smem, stream)
    time_variants("ssd_intra_chunk", build("ssd_intra_chunk", SSD_VARIANTS, tmp), args, outs,
                  wants, [B, nb, C, H, P, N])


def main():
    if not torch.cuda.is_available():
        print("ssm_variants: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    which = sys.argv[1:] or ["rglru", "ssd"]
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        for kernel in which:
            {"rglru": rglru, "ssd": ssd}[kernel](tmp, g, stream)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
