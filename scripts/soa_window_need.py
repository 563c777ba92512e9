#!/usr/bin/env python3
"""The job-window lifetime that whole SoA fans need, fan by fan.

Each fan runs the round loop at the horizon's window (every job of the
drive in it, so none can slide out), then reads from the loop's final
planes what :func:`repro_torch.core.sim.soa._window_need` reads: the
least lifetime bound whose window holds every job of every lane to the
round that resolves it.  The largest ratio of two fans' needs is the
least room a fit learnt from one fan needs to hold every other
(``repro_torch.scenarios.runner._SOA_FIT_MARGIN``).

    python3 scripts/soa_window_need.py --config ads-l4-x9 \\
        --traffic commute-ads_tile --fans 16 --seed-base 987654321000

Fan ``k`` takes the lanes ``seed_base + k * lanes + (0 .. lanes - 1)``.
It prints one JSON line a fan (the need, the widest window span in jobs,
the longest stay of a job in its window, the loop's seconds), then a
summary line with the needs' largest ratio and the window width that
each candidate margin gives, and the card's name and power limit.  On
the CPU (``--device cpu``) keep it to a few lanes and a short drive
(``--lanes 2 --duration 0.05``).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="ads-l4-x9")
    ap.add_argument("--traffic", default="commute-ads_tile")
    ap.add_argument("--fans", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=None, help="the config's lanes_per_fan")
    ap.add_argument("--seed-base", type=int, default=987654321000)
    ap.add_argument("--duration", type=float, default=None, help="the traffic's drive")
    ap.add_argument("--margins", type=float, nargs="*", default=[1.1, 1.2, 1.3, 1.4, 1.5])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from h100bench import harness
    from h100bench.systems.soa import _spec
    from repro_torch.core.sim import soa
    from repro_torch.core.sim import soa_kernels as K
    from repro_torch.core.sim.batch import sample_trace_batch
    from repro_torch.core.sim.trace import build_skeleton
    from repro_torch.scenarios import runner

    config, traffic = harness.load_config(args.config), harness.load_traffic(args.traffic)
    lanes = args.lanes or int(config["deployment"]["lanes_per_fan"])
    spec = _spec(config, traffic)
    if args.duration is not None:
        spec = dataclasses.replace(spec, duration_s=args.duration)
    wf, model, sched, pf = runner._prepare_run(spec)
    scen = spec.scenario
    duration = scen.duration_s if spec.duration_s is None else spec.duration_s
    skel = build_skeleton(wf, scen, duration)
    base = soa.default_life(wf, skel)

    def build(life, need=False):
        return soa.build_problem(
            wf, model, sched, pf, runner._make_run_policy(spec, pf), scen, duration,
            replan=spec.replan, n_lanes=lanes, drop_policy=spec.drop_policy,
            options=soa.SoaOptions(life_pad_s=life - base), measure_need=need)

    horizon = build(duration + 1.0, need=True)
    needs = []
    for k in range(args.fans):
        seeds = [args.seed_base + k * lanes + j for j in range(lanes)]
        t = time.perf_counter()
        btrace = sample_trace_batch(skel, model, scen, seeds, device=args.device)
        out = K.simulate(horizon.cfg, horizon.const, soa._lanes(horizon, btrace),
                         device=args.device)
        loop_s = time.perf_counter() - t
        need = soa._window_need(horizon, out)
        r = soa._resolve_rounds(horizon, out)
        rel, t1 = horizon.need.release, horizon.need.t1
        hi = np.searchsorted(rel, t1, side="right")
        n = horizon.n_real
        span = int(np.max(hi[r] - np.arange(n)))
        released = np.arange(n)[None, :] < hi[r]
        stay = float(np.max(np.where(released, t1[r] - rel[None, :], 0.0)))
        needs.append(need)
        print(json.dumps({"fan": k, "seeds": [seeds[0], seeds[-1]], "need_s": need,
                          "span_jobs": span, "longest_stay_s": stay,
                          "horizon_W": horizon.cfg.W, "loop_s": round(loop_s, 3)}), flush=True)
        del out, btrace
    lo, hi_need = min(needs), max(needs)
    widths = {str(m): build(hi_need * m).cfg.W for m in args.margins}
    print(json.dumps({"fans": len(needs), "lanes": lanes, "need_min_s": lo, "need_max_s": hi_need,
                      "largest_ratio": hi_need / lo if lo > 0 else None,
                      "W_at_need_max": build(hi_need).cfg.W, "W_at_margin_x_need_max": widths,
                      "default_life_s": base, "device": args.device,
                      "torch": torch.__version__}), flush=True)
    print(_card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
