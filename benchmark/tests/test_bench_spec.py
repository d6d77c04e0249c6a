"""BENCHMARK.json against the contract's shape, and every piece found by
its name."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("kind", ["config", "traffic", "limits"])
def test_every_cell_finds_its_files(bench, kind):
    for w in bench["workloads"]:
        got = {"config": lambda: spec.config(w["config"]), "traffic": lambda: spec.traffic(w["traffic"]),
               "limits": lambda: spec.limits(w["name"])}[kind]()
        assert got


def test_config_files_state_their_cuts(bench):
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) == sorted(cfg["published"])
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        reader = spec.reader(m["name"])
        assert reader.SOURCE == m["source"] and callable(reader.read)


def test_every_cell_reports_setup_and_another_end_to_end_metric(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(bench["end_to_end"], w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(bench["per_layer"], w["name"])


def test_a_missing_piece_raises():
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")
    with pytest.raises(KeyError):
        spec.workload({"workloads": []}, "nothing")
