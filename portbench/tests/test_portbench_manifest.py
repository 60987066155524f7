"""BENCHMARK.json: the names, units and keys the benchmark's contract asks
for, and a file for everything it names."""

import json
import re

import pytest

from portbench.harness import loader, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.load()


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"] and MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((loader.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["source"].startswith("https://") and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((loader.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert (loader.BENCH / "configs" / f"{c['name']}.py").is_file()
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])


def test_workloads():
    configs = {c["name"] for c in MAN["configs"]}
    assert 1 <= len(MAN["workloads"]) <= 24
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and _one_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        kind = loader.data("traffic", w["traffic"])["kind"]
        assert (loader.BENCH / "kinds" / f"{kind}.py").is_file()
    assert len(pairs) == len(MAN["workloads"]) == len({w["name"] for w in MAN["workloads"]})


def test_metrics():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert {"leaves_per_s", "proofs_per_s", "job_p95_ms", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (loader.BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in manifest.end_to_end(MAN, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(MAN, cell)


def test_layers_named_alike():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
