"""The fitted job window's metric: one per-layer entry appended for the
cockpit x9 cell alone, every entry that was there before left as it was,
and a reader that gives the share of the window's fans that ran at the
fit (None where the program has no such counter)."""
import pytest

from h100bench import harness
from h100bench.tracing import TraceData

BENCH = harness.load_benchmark()
NAME, CELL = "window_fit_share.x9", "soa-ads-x9-commute"

_X4, _X9 = ["soa-ads-commute"], [CELL]
#: every per-layer entry before this one: name, unit, better, source,
#: layer, moves, workloads
OLDER_PER_LAYER = [
    ("soa_retries_per_fan", "retries", "lower", "program_counter", "SoA entry", _X4),
    ("host_s_per_fan", "s", "lower", "program_span", "host set-up, sampler and reports", _X4),
    ("rounds_per_s", "rounds/s", "higher", "program_span", "round loop", _X4),
    ("alloc_ladder_roofline", "%", "higher", "device_trace", "allocator kernel", _X4),
    ("device_idle_pct.soa", "%", "lower", "device_trace", "device", _X4),
    ("round_issue_us", "us", "lower", "program_span", "round loop", _X4),
    ("lane_stage_s_per_fan", "s", "lower", "program_span", "lane staging", _X4),
    ("loop_drain_s_per_fan", "s", "lower", "program_span", "round loop", _X4),
    ("kernels_per_round", "kernels", "lower", "device_trace", "round loop", _X4),
    ("graphed_round_share", "share", "higher", "program_counter", "round loop", _X4),
    ("window_live_share.x9", "share", "higher", "program_counter", "round loop", _X9),
    ("subround_realloc_share.x9", "share", "higher", "program_counter", "round loop", _X9),
]
OLDER_END_TO_END = [
    {"name": "drive_s_per_s", "unit": "drive-s/s", "better": "higher", "bound": 0.25,
     "source": "host_clock"},
    {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
]


def _entry(name, unit, better, source, layer, workloads):
    return {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
            "moves": "drive_s_per_s", "workloads": workloads}


def test_the_metric_is_appended_for_the_x9_cell_alone():
    *older, new = BENCH["per_layer"]
    assert new == _entry(NAME, "share", "higher", "program_counter", "SoA entry", [CELL])
    assert len(older) == len(OLDER_PER_LAYER)
    assert NAME in {m["name"] for m in harness.cell_metrics(BENCH, CELL, "per_layer")}
    assert NAME not in {m["name"] for m in harness.cell_metrics(BENCH, "soa-ads-commute",
                                                                "per_layer")}


@pytest.mark.parametrize("i", range(len(OLDER_PER_LAYER)),
                         ids=[row[0] for row in OLDER_PER_LAYER])
def test_every_older_per_layer_entry_is_as_it_was(i):
    assert BENCH["per_layer"][i] == _entry(*OLDER_PER_LAYER[i])


def test_the_end_to_end_metrics_and_the_cells_are_as_they_were():
    assert BENCH["end_to_end"] == OLDER_END_TO_END
    assert [c["name"] for c in BENCH["workloads"]] == ["soa-ads-commute", CELL]
    assert [c["name"] for c in BENCH["configs"]] == ["ads-l4-x4", "ads-l4-x9"]
    assert (BENCH["run_seconds"], BENCH["paths"]) == (45, ["h100bench"])


def _trace(fans=3, **counters):
    return TraceData(counters={k: v for k, v in counters.items() if v is not None},
                     extras={"fans": fans})


def test_the_reader_gives_the_share_of_fans_at_the_fit():
    read = harness.load_reader(NAME)
    assert read(_trace(soa_window_fit_hits=2, soa_window_retries=1)) == pytest.approx(2 / 3)
    assert read(_trace(soa_window_fit_hits=3)) == 1.0
    assert read(_trace(soa_window_fit_hits=0, soa_window_retries=3)) == 0.0


def test_the_reader_gives_none_without_the_counter():
    read = harness.load_reader(NAME)
    assert read(_trace(soa_window_retries=0, soa_rounds=8000)) is None
    assert read(_trace(fans=0, soa_window_fit_hits=0)) is None
    assert read(TraceData()) is None
