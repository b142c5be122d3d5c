"""BENCHMARK.json against the rules the harness and its readers rely on."""

import json
import re

import pytest
from hvdb import cells, record, runner

BENCH = json.loads(runner.BENCH.read_text())
#: BENCHMARK.json with the held cells, which have to meet the same rules
ALL = runner.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_held"])
def test_names_and_units(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    names += [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in bench["end_to_end"] + bench["per_layer"])) == len(
        bench["end_to_end"] + bench["per_layer"])
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in bench["end_to_end"] + bench["per_layer"])


@pytest.mark.parametrize("wl", [w["name"] for w in ALL["workloads"]])
def test_every_cell_finds_its_files_and_metrics(wl):
    entry, cfg, traffic = runner.cell_spec(ALL, wl)
    assert entry["chips"] in (1, 4)
    assert callable(cells.step_kind(traffic["step"]))
    e2e, layers = runner.cell_metrics(ALL, wl)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and traffic["metric"] in names and len(names) == 2
    assert layers
    for m in layers:
        assert m["moves"] in names
        reader = record.load_reader(m["name"])
        assert callable(reader.read)


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_held"])
def test_every_metric_moves_an_end_to_end_metric_its_cells_report(bench):
    cells_ = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells_
        for wl in m["workloads"]:
            assert m["moves"] in {x["name"] for x in runner.cell_metrics(bench, wl)[0]}
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_bounds_and_limits():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_held"])
def test_configs_are_files_under_paths(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        cfg = json.loads((runner.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg and NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_a_step_kind_is_found_by_its_file_name():
    assert cells.step_kind("search") is cells.step_kind("delta") is cells.SceneCell
    assert cells.step_kind("sweep") is cells.SweepCell
    with pytest.raises(SystemExit, match="no step kind"):
        cells.step_kind("no_such_kind")


@pytest.mark.parametrize("metric, file", [
    ("route_s.search", "route_s.py"), ("route_s.sweep", "route_s.py"),
    ("device_idle.delta", "device_idle.py"), ("db_s.search", "db_s.py"),
])
def test_a_reader_serves_every_cell_of_its_layer(metric, file):
    assert record.load_reader(metric).__file__.endswith("/layers/" + file)


def test_the_held_cells_are_not_in_the_benchmark():
    held = {w["name"] for w in runner.load_json(runner.HELD)["workloads"]}
    assert held and not held & {w["name"] for w in BENCH["workloads"]}
    assert held <= {w["name"] for w in ALL["workloads"]}
