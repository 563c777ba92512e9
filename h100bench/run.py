#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last);
the last lines of standard error give each compared number beside its
limit.  Without enough CUDA devices, or with ``jax`` or the JAX package
``repro`` loaded once the window has closed, it prints no result and
exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """The import path, and every build and kernel cache inside the
    checkout at a fixed place."""
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from h100bench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {n}; no result", file=sys.stderr)
        return 2
    system = harness.load_system(config["system"])
    res = system.run_cell(config, traffic, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda", t_start=T_START)
    line = harness.result_line(bench, args.workload, res, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"h100bench: forbidden modules loaded: {bad}; no result", file=sys.stderr)
        return 3
    for text in harness.check_lines(res.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
