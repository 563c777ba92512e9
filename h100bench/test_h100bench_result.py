"""The result line's keys, the compared numbers last, and what a run may
import."""
import json
import os
import subprocess
import sys
from pathlib import Path

from h100bench import harness
from h100bench.tracing import TraceData

ROOT = Path(__file__).resolve().parent.parent


def _result(trace):
    data = TraceData(counters={"soa_window_retries": 0, "soa_rounds": 2000},
                     phases={"soa_loop": {"n": 1, "total_s": 10.0, "mean_s": 10.0}},
                     extras={"fans": 2})
    return harness.CellResult(
        end_to_end={"drive_s_per_s": 150.0, "setup_s": 40.0}, attempted=2048, failed=0,
        checks=[harness.Check("draw_rel_err", 1e-16, 1e-9)],
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                "memory_peak_bytes": 1},
        trace=data if trace else None)


def test_result_line_keys_and_order():
    bench = harness.load_benchmark()
    line = harness.result_line(bench, "soa-ads-commute", _result(False), False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and set(line["metrics"]) == {"drive_s_per_s", "setup_s"}
    assert line["metrics"]["drive_s_per_s"] == {"value": 150.0, "unit": "drive-s/s"}
    assert line["checks"] == {"draw_rel_err": {"value": 1e-16, "limit": 1e-9}}
    json.dumps(line)


def test_traced_line_holds_the_per_layer_metrics_it_read():
    bench = harness.load_benchmark()
    line = harness.result_line(bench, "soa-ads-commute", _result(True), True)
    assert line["metrics"]["rounds_per_s"] == {"value": 200.0, "unit": "rounds/s"}
    assert line["metrics"]["soa_retries_per_fan"]["value"] == 0.0
    # nothing to read: no profiled window, so no roofline or idle share
    assert "alloc_ladder_roofline" not in line["metrics"]
    assert "device_idle_pct.soa" not in line["metrics"]


def test_a_failed_check_makes_the_run_not_correct():
    res = _result(False)
    res.checks.append(harness.Check("lat_ks", 0.5, 0.01))
    assert not res.correct
    assert harness.check_lines(res.checks)[-1].endswith("FAILED")
    res.checks[-1] = harness.Check("lat_ks", float("nan"), 0.01)
    assert not res.correct


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({"repro_torch", "repro_torch.core", "jaxtyping"}) == []
    assert harness.forbidden_modules({"repro.core", "jax", "flax.linen"}) == [
        "flax.linen", "jax", "repro.core"]


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "sys.path[:0] = [{root!r}, {src!r}]\n"
        "import h100bench.run, h100bench.calibrate, h100bench.harness\n"
        "import h100bench.systems.soa, h100bench.ref_soa.lanes\n"
        "from h100bench import harness\n"
        "from repro_torch.scenarios import run\n"
        "from repro_torch.core.sim import soa_kernels\n"
        "for name in harness.load_benchmark()['per_layer']:\n"
        "    harness.load_reader(name['name'])\n"
        "print(harness.forbidden_modules())\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return          # the card's machine: the refusal is not reachable there
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "soa-ads-commute",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
