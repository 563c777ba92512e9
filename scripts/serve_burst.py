#!/usr/bin/env python3
"""Repeat the serve burst of ``chip_smoke.py`` for one arch on one CUDA card.

The reference launcher's traffic (12 requests, prompt 16, 16 new tokens,
batch 4, max_len 128) on one set of random weights (seed 0), ``--bursts``
times, each on a fresh engine, after one warm-up burst; then 12 prefills
of one prompt through the engine.  Prints one JSON line: tokens/s per burst
and the mean wall ms of a prefill per burst, then the card's name and power
limit.  It imports whichever ``repro_torch`` PYTHONPATH names, so two trees
can be compared in one call:

    PYTHONPATH=src python3 scripts/serve_burst.py --arch mamba2_2p7b
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, Request, ServingEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2_2p7b")
    ap.add_argument("--bursts", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_burst: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    cfg = get_config(args.arch)
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    ecfg = EngineConfig(max_batch=4, max_len=128)
    tokens_per_s, prefill_ms = [], []
    for rep in range(args.bursts + 1):
        eng = ServingEngine(cfg, params, ecfg, device="cuda")
        rng = np.random.RandomState(rep)
        reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32),
                        max_new_tokens=16) for i in range(12)]
        torch.cuda.synchronize()
        t = time.time()
        for r in reqs:
            r.arrival_s = time.time()
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.time() - t
        toks = torch.as_tensor(reqs[0].prompt.astype(np.int64), device="cuda")[None]
        t = time.perf_counter()
        for _ in range(12):
            eng._prefill(toks, 0)
        torch.cuda.synchronize()
        if rep:  # the first burst warms up
            tokens_per_s.append(sum(len(r.generated) for r in reqs) / wall)
            prefill_ms.append((time.perf_counter() - t) / 12 * 1e3)
    print(json.dumps({"arch": cfg.name, "tokens_per_s": tokens_per_s,
                      "prefill_ms": prefill_ms}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
