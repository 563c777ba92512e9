"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine on the reduced config with a burst
of synthetic requests, on the card unless ``--device cpu`` is given.  It
takes every arch; musicgen fails at its first prefill, as the reference's
launcher does, since the engine feeds (B, S) tokens and the codebook
frontend takes (B, K, S) (ROADMAP C14).  ``chip_smoke.py`` drives the same
engine at full width for every other arch (deepseek-v2 at depth 4) and
musicgen through ``LM.prefill`` / ``decode_step``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3p8b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    engine = ServingEngine(
        cfg, params, EngineConfig(max_batch=args.batch, max_len=128), device=dev
    )

    rng = np.random.RandomState(0)
    t0 = time.time()
    reqs = []
    for i in range(args.requests):
        r = Request(
            rid=i,
            prompt=rng.randint(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32),
            max_new_tokens=args.max_new,
            arrival_s=time.time(),
        )
        reqs.append(r)
        engine.submit(r)

    engine.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in reqs)
    print(
        f"[serve] {args.arch} on {dev}: {len(reqs)} requests, {toks} tokens "
        f"in {dt:.2f}s ({toks/dt:.1f} tok/s, batch={args.batch})"
    )
    lat = [r.finish_s - r.arrival_s for r in reqs if r.finish_s]
    print(
        f"[serve] latency p50={np.percentile(lat,50)*1e3:.0f}ms "
        f"p99={np.percentile(lat,99)*1e3:.0f}ms"
    )


if __name__ == "__main__":
    main()
