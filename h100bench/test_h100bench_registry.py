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


def _keeps_to_its_shape(bench):
    cells = [c["name"] for c in bench["workloads"]]
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"] and bench["command"][1].startswith("h100bench/")
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and len(cells) == len(set(cells))
    assert "setup_s" in names
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert isinstance(m.get("workloads"), list) and m["workloads"]
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = {(c["config"], c["traffic"]) for c in bench["workloads"]}
    assert len(pairs) == len(cells)
    assert sum(c["chips"] == 4 for c in bench["workloads"]) <= max(1, len(cells) // 4)


def test_benchmark_file_keeps_to_its_shape():
    _keeps_to_its_shape(BENCH)


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


def _soa_cell(here: Path, bench: dict) -> set:
    """A new SoA seed fan: its configuration file and entry, its cell on
    a traffic mix the benchmark has, and a per-layer metric of its own;
    it reports the benchmark's end-to-end metrics."""
    cfg = harness.load_config("ads-l4-x4")
    cfg.update(name="new-config", source="the L4 ADS benchmark, cockpit x9",
               deployment={**cfg["deployment"], "cockpit_replicas": 9})
    (here / "configs" / "new-config.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "new-config", "source": cfg["source"],
                             "file": "h100bench/configs/new-config.json", "reduced": [],
                             "why": "a later PR's deployment"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "commute-ads_tile", "chips": 1,
                               "why": "a later PR's cell"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "a layer",
                               "moves": "drive_s_per_s", "workloads": ["new-cell"]})
    return {"drive_s_per_s", "setup_s"}


def _other_system(here: Path, bench: dict) -> set:
    """A cell of another kind: its own traffic and end-to-end metric, and
    ``drive_s_per_s`` given the list of the accepted cells."""
    (here / "configs" / "new-config.json").write_text(json.dumps(
        {"name": "new-config", "system": "other", "source": "a paper", "reduced": []}))
    (here / "traffic" / "new-mix.json").write_text(json.dumps({"name": "new-mix", "rate": 3}))
    assert harness.load_traffic("new-mix", here=here)["rate"] == 3
    bench["configs"].append({"name": "new-config", "source": "a paper",
                             "file": "h100bench/configs/new-config.json", "reduced": [],
                             "why": "a later PR's system"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config", "traffic": "new-mix",
                               "chips": 1, "why": "a later PR's cell"})
    bench["end_to_end"].append({"name": "new_rate", "unit": "ops/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["new-cell"]})
    drive = next(m for m in bench["end_to_end"] if m["name"] == "drive_s_per_s")
    assert "workloads" not in drive
    drive["workloads"] = list(CELLS)
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "a layer",
                               "moves": "new_rate", "workloads": ["new-cell"]})
    return {"new_rate", "setup_s"}


def _names(bench: dict, cell: str, kind: str) -> set:
    return {m["name"] for m in harness.cell_metrics(bench, cell, kind)}


@pytest.mark.parametrize("add", [_soa_cell, _other_system], ids=["soa_cell", "other_system"])
def test_a_new_config_traffic_and_metric_come_from_added_files(tmp_path, add):
    """What a later PR adds: a configuration file, a reader and their
    entries, and a traffic file where the mix is new.  A SoA cell changes
    nothing that exists; a cell of another kind changes only the list of
    ``drive_s_per_s``."""
    for sub in ("configs", "traffic", "layers"):
        (tmp_path / sub).mkdir()
    (tmp_path / "layers" / "new_metric.x.py").write_text(
        "def read(t):\n    return t.extras.get('thing')\n")
    bench = json.loads(json.dumps(BENCH))
    e2e = add(tmp_path, bench)
    _keeps_to_its_shape(bench)

    cfg = harness.load_config("new-config", here=tmp_path)
    if add is _soa_cell:
        assert cfg["system"] == "soa" and cfg["deployment"]["cockpit_replicas"] == 9
        assert harness.load_system(cfg["system"]).run_cell
        assert harness.load_traffic(harness.find_cell(bench, "new-cell")["traffic"])
    read = harness.load_reader("new_metric.x", here=tmp_path)
    from h100bench.tracing import TraceData

    assert read(TraceData(extras={"thing": 7.0})) == 7.0 and read(TraceData()) is None
    assert _names(bench, "new-cell", "end_to_end") == e2e
    assert _names(bench, "new-cell", "per_layer") == {"new_metric.x"}
    for cell in CELLS:     # the old cells report what they did, no more
        assert _names(bench, cell, "end_to_end") == _names(BENCH, cell, "end_to_end")
        assert "drive_s_per_s" in _names(bench, cell, "end_to_end")
        assert _names(bench, cell, "per_layer") == _names(BENCH, cell, "per_layer")

    # every entry the benchmark had is as it was; the new ones come after
    if add is _other_system:
        drive = next(m for m in bench["end_to_end"] if m["name"] == "drive_s_per_s")
        assert drive.pop("workloads") == CELLS
    added = {"configs": 1, "workloads": 1, "per_layer": 1, "end_to_end": add is _other_system}
    for key, was in BENCH.items():
        now = bench[key]
        if key in added:
            assert now[:len(was)] == was and len(now) == len(was) + added[key]
        else:
            assert now == was


def test_a_file_named_otherwise_is_refused(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "a.json").write_text(json.dumps({"name": "b"}))
    with pytest.raises(ValueError):
        harness.load_config("a", here=tmp_path)
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such-cell")
