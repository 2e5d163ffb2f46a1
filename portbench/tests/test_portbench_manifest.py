"""BENCHMARK.json against the benchmark's contract, and every part of it found by name."""
import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = manifest.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher") and e["source"] in SOURCES
        for k in ("why", "layer") + (("source",) if section == "configs" else ()):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())


def test_every_cell_found_by_name():
    cells = BENCH["workloads"]
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    for c in cells:
        w = manifest.workload(c["name"])
        assert (w["name"], w["config"], w["traffic"], w["chips"], w["why"]) == (
            c["name"], c["config"], c["traffic"], c["chips"], c["why"])
        assert manifest.config(w["config"])["name"] == w["config"]
        assert hasattr(manifest.driver(w["driver"]), "setup")
        assert w["limits"] and all(v > 0 for v in w["limits"].values())


def test_every_config_file_and_its_cuts():
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/") and conf["name"] == c["name"]
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert all(not (k.endswith("_dim") or k.endswith("_rank")) for k in c["reduced"])


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for c in BENCH["workloads"]:
        e2e, per_layer = manifest.cell_metrics(BENCH, c["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer, c["name"]


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
        assert hasattr(manifest.reader(m["name"]), "read")
        layers.setdefault(m["layer"], []).append(m["name"])
    assert {"trunk kernels", "device", "whole step"} <= set(layers)
