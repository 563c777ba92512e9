#!/usr/bin/env python3
"""Serve and train speed of two trees of ``repro_torch`` on one CUDA card.

For each arch, ``scripts/serve_burst.py`` (tokens per second of the
serve burst, prefill ms) and ``scripts/train_steps.py`` (step ms, peak
memory) run in fresh processes, each with PYTHONPATH set to one tree's
``src``, in the order baseline, this, this, baseline.  Prints one JSON
line per run, then a summary line (the median of each run's readings)
and the card's name and power limit; writes everything to ``--out``.

    python3 scripts/ab_serve_train.py --baseline OTHER/src \\
        --archs granite_moe_1b,phi4_mini_3p8b
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, src, arch, extra=()):
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, os.path.join(HERE, "scripts", script), "--arch", arch,
                          *extra], env=env, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        sys.exit(f"{script} {arch} ({src}) failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, help="the other tree's src directory")
    ap.add_argument("--archs", default="granite_moe_1b,phi4_mini_3p8b")
    ap.add_argument("--bursts", type=int, default=5, help="serve bursts a run")
    ap.add_argument("--serve-only", action="store_true")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out", "ab_serve_train.json"))
    args = ap.parse_args()
    order = [("baseline", os.path.abspath(args.baseline)), ("this", os.path.join(HERE, "src"))]
    order = order + order[::-1]
    runs, summary = [], {}
    for arch in args.archs.split(","):
        jobs = [("serve_burst.py", ("tokens_per_s", "prefill_ms"), ("--bursts", str(args.bursts))),
                ("train_steps.py", ("step_ms", "tokens_per_s", "peak_gb"), ())]
        for script, keys, extra in jobs[:1] if args.serve_only else jobs:
            for tag, src in order:
                row = dict(_run(script, src, arch, extra), tree=tag, script=script)
                print(json.dumps(row), flush=True)
                runs.append(row)
                for k in keys:
                    v = row[k]
                    med = statistics.median(v) if isinstance(v, list) else v
                    summary.setdefault(f"{arch} {script} {k}", []).append([tag, med])
    print(json.dumps({"summary": summary}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"runs": runs, "summary": summary, "card": card}, f, indent=1)


if __name__ == "__main__":
    main()
