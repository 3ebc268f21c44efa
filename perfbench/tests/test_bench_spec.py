"""BENCHMARK.json within the limits its format sets (names, units, keys,
sizes), and every file a cell names found by its name."""

import json
import re

import pytest

from perfbench.run import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(SPEC) == KEYS
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["perfbench"] and len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) for w in SPEC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"].startswith("perfbench/") and (ROOT / entry["file"]).is_file()
    assert entry["reduced"] == [] or all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_workload_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and TEXT.match(cell["why"])
    assert cell["chips"] == 1
    workload = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert workload["config"] == cell["config"] and workload["traffic"] == cell["traffic"]
    assert (BENCH / "traffic" / f"{cell['traffic']}.py").is_file()
    assert workload["limits"] and workload["control"]
    reports = [m["name"] for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in reports and len(reports) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert (BENCH / "layer_metrics" / f"{metric['name'].split('.')[0]}.py").is_file()
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
            assert metric["better"] == "higher"


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
