#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one
configuration under one traffic mix (a cell of ``BENCHMARK.json`` or
one left out of it): the program on each of ``--seeds`` and the controls
on each of ``--control-seeds``, one JSON line each.  Not run by the
benchmark's own runs.

    python3 h100bench/calibrate.py --config ads-l4-x4 --traffic commute-ads_tile \
        --seeds 1 2 3 --control-seeds 1 2 3
"""
import argparse
import json
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from h100bench import run as entry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    entry._environment()
    from h100bench import harness

    config = harness.load_config(args.config)
    traffic = harness.load_traffic(args.traffic)
    system = harness.load_system(config["system"])
    rows = system.calibrate(config, traffic, seeds=args.seeds,
                            control_seeds=args.control_seeds, device="cuda")
    for row in rows:
        print(json.dumps({"config": args.config, "traffic": args.traffic, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
