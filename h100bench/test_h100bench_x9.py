"""The cockpit x9 deployment and its cell: the configuration is the x4
one at nine cockpit replicas with a tighter chain-latency limit, the cell
reports the benchmark's end-to-end metrics and two per-layer metrics of
its own, the x4 cell still reports what it did, and the new readers read
the program's counters (None where the program has none).  Every check
is one of membership, so that a later cell or metric comes in by
additions alone."""
import pytest

from h100bench import harness
from h100bench.tracing import TraceData

BENCH = harness.load_benchmark()
CELL, CONFIG = "soa-ads-x9-commute", "ads-l4-x9"
NEW_METRICS = {"window_live_share.x9", "subround_realloc_share.x9"}
#: what the x4 cell reported before the x9 cell came in
X4_PER_LAYER = {"soa_retries_per_fan", "host_s_per_fan", "rounds_per_s",
                "alloc_ladder_roofline", "device_idle_pct.soa", "round_issue_us",
                "lane_stage_s_per_fan", "loop_drain_s_per_fan", "kernels_per_round",
                "graphed_round_share"}


def _names(cell, kind):
    return {m["name"] for m in harness.cell_metrics(BENCH, cell, kind)}


def test_the_config_and_the_cell_are_in_the_benchmark():
    [cfg] = [c for c in BENCH["configs"] if c["name"] == CONFIG]
    assert cfg["file"] == f"h100bench/configs/{CONFIG}.json" and cfg["reduced"] == []
    cell = harness.find_cell(BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "commute-ads_tile", 1)


def test_the_new_entries_come_after_the_old_ones():
    configs = [c["name"] for c in BENCH["configs"]]
    cells = [c["name"] for c in BENCH["workloads"]]
    per_layer = [m["name"] for m in BENCH["per_layer"]]
    assert configs.index("ads-l4-x4") < configs.index(CONFIG)
    assert cells.index("soa-ads-commute") < cells.index(CELL)
    assert max(per_layer.index(n) for n in X4_PER_LAYER) < min(
        per_layer.index(n) for n in NEW_METRICS)


def test_the_cell_reports_the_end_to_end_metrics_and_its_own():
    assert {"drive_s_per_s", "setup_s"} <= _names(CELL, "end_to_end")
    assert NEW_METRICS <= _names(CELL, "per_layer")
    for m in BENCH["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert (m["layer"], m["moves"], m["source"], m["unit"]) == (
                "round loop", "drive_s_per_s", "program_counter", "share")
            assert CELL in m["workloads"] and "soa-ads-commute" not in m["workloads"]


def test_the_x4_cell_reports_what_it_did():
    assert {"drive_s_per_s", "setup_s"} <= _names("soa-ads-commute", "end_to_end")
    assert X4_PER_LAYER <= _names("soa-ads-commute", "per_layer")


def test_the_x9_config_is_the_x4_one_at_nine_cockpits():
    x4, x9 = harness.load_config("ads-l4-x4"), harness.load_config(CONFIG)
    assert x9["deployment"]["cockpit_replicas"] == 9
    assert "cockpit_replicas=9" in x9["deployment"]["benchmark"]
    assert x9["source"].endswith("cockpit x9")
    for cfg in (x4, x9):
        for key in ("name", "source", "check_readings", "guarantees"):
            cfg.pop(key)
        for key in ("benchmark", "cockpit_replicas"):
            cfg["deployment"].pop(key)
        cfg["checks"].pop("lat_ks")
    assert x9 == x4


def test_the_limits_of_correct_are_the_contract_s():
    """The x4 cell's limits, but the chain latencies': tighter than the
    contract's 0.08, between the sound runs' largest reading and the
    least of one round a 1 ms step, which meets 0.08 at x9 too."""
    cfg = harness.load_config(CONFIG)
    checks, ks = cfg["checks"], cfg["check_readings"]["lat_ks"]
    assert {k: v for k, v in checks.items() if k != "lat_ks"} == {
        "draw_rel_err": 1e-8, "invariants_differing": 0.0, "busy_lane_gap": 0.04}
    assert ks["lower"] < checks["lat_ks"] < ks["upper"] < 0.08


def _trace(**counters):
    """Two fans at W = 2368 and R = 1024, a tenth of the reallocations in
    sub-rounds."""
    c = {"soa_rounds": 8000, "soa_reallocs": 1000 * 1024, "soa_subround_reallocs": 100 * 1024,
         "soa_window_live": 8000 * 1024 * 300, "soa_window_cols": 8000 * 1024 * 2368}
    c.update(counters)
    return TraceData(counters={k: v for k, v in c.items() if v is not None},
                     extras={"fans": 2})


def test_the_readers_give_their_shares():
    read = harness.load_reader
    assert read("window_live_share.x9")(_trace()) == pytest.approx(300 / 2368)
    assert read("subround_realloc_share.x9")(_trace()) == pytest.approx(0.1)
    assert read("subround_realloc_share.x9")(_trace(soa_subround_reallocs=0)) == 0.0


@pytest.mark.parametrize("name, drop", [
    ("window_live_share.x9", "soa_window_live"), ("window_live_share.x9", "soa_window_cols"),
    ("subround_realloc_share.x9", "soa_subround_reallocs"),
    ("subround_realloc_share.x9", "soa_reallocs")])
def test_a_reader_gives_none_where_its_counter_is_missing(name, drop):
    assert harness.load_reader(name)(_trace(**{drop: None})) is None
    assert harness.load_reader(name)(TraceData()) is None
