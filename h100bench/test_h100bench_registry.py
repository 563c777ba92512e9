"""The benchmark finds every piece by name, and picks up new ones from
added files alone."""
import json
import re
from pathlib import Path

import pytest

from h100bench import harness

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_benchmark_file_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"] and BENCH["command"][1].startswith("h100bench/")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    assert "setup_s" in names
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in CELLS and cell in e2e[m["moves"]].get("workloads", CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = {(c["config"], c["traffic"]) for c in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_config_is_found_by_name():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"] == f"h100bench/configs/{c['name']}.json"
        cfg = harness.load_config(c["name"])
        assert cfg["source"] and cfg["reduced"] == c["reduced"]
        assert harness.load_system(cfg["system"]).run_cell
        assert (ROOT / c["file"]).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_pieces(cell):
    c = harness.find_cell(BENCH, cell)
    assert harness.load_traffic(c["traffic"])["name"] == c["traffic"]
    assert harness.load_config(c["config"])["name"] == c["config"]
    kinds = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in kinds and len(kinds) >= 2
    layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert layer
    for m in layer:
        assert callable(harness.load_reader(m["name"]))


def test_a_new_config_traffic_and_metric_come_from_added_files(tmp_path):
    """What a later PR adds: a configuration file, a traffic file, a
    reader and their entries; nothing that exists changes."""
    for sub in ("configs", "traffic", "layers"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps(
        {"name": "new-config", "system": "soa", "source": "a paper", "reduced": []}))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps({"name": "new-mix", "rate": 3}))
    (tmp_path / "layers" / "new_metric.x.py").write_text(
        "def read(t):\n    return t.extras.get('thing')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new-cell", "config": "new-config", "traffic": "new-mix",
                               "chips": 1, "why": "a later PR's cell"})
    bench["end_to_end"].append({"name": "new_rate", "unit": "ops/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["new-cell"]})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "a layer", "moves": "new_rate"})
    assert harness.load_config("new-config", here=tmp_path)["system"] == "soa"
    assert harness.load_traffic("new-mix", here=tmp_path)["rate"] == 3
    read = harness.load_reader("new_metric.x", here=tmp_path)
    from h100bench.tracing import TraceData

    assert read(TraceData(extras={"thing": 7.0})) == 7.0 and read(TraceData()) is None
    assert [m["name"] for m in harness.cell_metrics(bench, "new-cell", "per_layer")] == ["new_metric.x"]
    assert {m["name"] for m in harness.cell_metrics(bench, "new-cell", "end_to_end")} == {
        "new_rate", "setup_s"}
    for cell in CELLS:     # the old cells do not pick the new metric up
        assert "new_metric.x" not in {m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")}


def test_a_file_named_otherwise_is_refused(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "a.json").write_text(json.dumps({"name": "b"}))
    with pytest.raises(ValueError):
        harness.load_config("a", here=tmp_path)
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such-cell")
