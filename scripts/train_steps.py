#!/usr/bin/env python3
"""Time ``Trainer`` steps for one arch at full width on one CUDA card.

``launch/train.py``'s traffic (batch 8 x seq 128, seed 0): one warm-up
step, then ``--steps`` steps, each synchronised and timed on its own.
Prints one JSON line (step wall ms, tokens per second, peak memory),
then the card's name and power limit.  It imports whichever
``repro_torch`` PYTHONPATH names, so two trees can be compared in one
call (``scripts/ab_serve_train.py``):

    PYTHONPATH=src python3 scripts/train_steps.py --arch granite_moe_1b
"""
import argparse
import json
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.data import DataConfig, synthetic_stream


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_moe_1b")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_steps: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    cfg = get_config(args.arch)
    trainer = Trainer(cfg, TrainConfig(steps=0, log_every=1), seed=0, device="cuda")
    data = synthetic_stream(cfg, DataConfig(batch=8, seq_len=128), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(args.steps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.tcfg.steps = trainer.step + 1
        trainer.fit(data)
        torch.cuda.synchronize()
        if i:  # the first step warms up
            step_ms.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"arch": cfg.name, "step_ms": step_ms,
                      "tokens_per_s": [8 * 128 / (ms / 1e3) for ms in step_ms],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
