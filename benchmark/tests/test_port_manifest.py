"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from benchmark import harness

MANIFEST = json.loads((harness.ROOT / harness.MANIFEST).read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_command_and_paths():
    assert set(MANIFEST) == KEYS
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1] == "benchmark/run.py"
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["why"])
    assert _line(conf["source"]) and conf["source"].startswith("https://")
    assert conf["file"].startswith("benchmark/configs/")
    body = json.loads((harness.ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"]
    assert conf["reduced"] == body["reduced"] == []
    assert any(w["config"] == conf["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_and_metrics(name):
    wl = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["traffic"]) and _line(wl["why"])
    assert wl["chips"] == 1
    cell = harness.load_cell(name)
    assert (harness.HERE / "entries"
            / f"{cell['traffic']['entry']}.py").exists()
    numbers = {"loss_gap", "grad_gap", "update_gap"}
    assert set(cell["limits"]) == numbers
    assert "grad_gap" in cell["limits"]
    assert all(0 < v < 1 for v in cell["limits"].values())
    e2e = [m["name"] for m in cell["metrics"]["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["metrics"]["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    per_layer = metric in MANIFEST["per_layer"]
    keys = {"name", "unit", "better", "source"}
    keys |= {"layer", "moves"} if per_layer else {"bound"}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").exists()
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    if per_layer:
        assert _line(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        moved = next(m for m in MANIFEST["end_to_end"]
                     if m["name"] == metric["moves"])
        for cell in metric.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
    else:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25
        if metric["name"] == "setup_s":
            assert metric["bound"] <= 0.25


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    total = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
