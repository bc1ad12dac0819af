"""BENCHMARK.json and the files it names: found by name, within the
contract's limits."""

import json
import os
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    cell = spec.Cell(BENCH, w["name"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1
    assert cell.config["name"] == w["config"]
    assert cell.traffic["clients"] >= 1
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_file(c):
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = spec.config(c["name"])
    assert cfg["source"] == c["source"]
    assert c["reduced"] == []
    assert "residual_ratio" in cfg["limits"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(m):
    reader = spec.metric_reader(m["name"])
    assert reader.UNIT == m["unit"]
    assert callable(reader.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert m["source"] in {"device_trace", "program_span", "program_counter",
                           "host_clock"}


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_a_new_cell_needs_only_files(tmp_path, monkeypatch):
    cfg_dir = os.path.join(spec.HERE, "configs")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "kafka-10k-expand.other", "config": "kafka-10k-expand",
         "traffic": "headline-h8", "chips": 1, "why": "x"}])
    cell = spec.Cell(bench, "kafka-10k-expand.other")
    assert cell.config == json.load(open(os.path.join(
        cfg_dir, "kafka-10k-expand.json")))
    assert cell.client_flags()[-1] == "-broker-ids=" + ",".join(
        str(b) for b in range(1, 101))
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in BENCH["per_layer"] if "workloads" not in m]
