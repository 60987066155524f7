"""``BENCHMARK.json``: a cell, and the metrics it reports."""

from __future__ import annotations

import json

from portbench.harness.loader import ROOT


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end(manifest: dict, cell_name: str) -> list:
    return [m for m in manifest["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: dict, cell_name: str) -> list:
    moves = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if cell_name in m["workloads"] or ("workloads" not in m and m["moves"] in moves)]
