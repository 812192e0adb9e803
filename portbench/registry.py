"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file, and a traffic mix, the data file
``portbench/traffic/<traffic>.json``.  The traffic file names its driver,
the module ``portbench.drivers.<driver>``, and each metric is read by the
module ``portbench.metrics.<name>``.  Adding a cell, a mix or a metric is
adding files and entries: nothing here names one.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, Mapping

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: Mapping, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: everywhere unless its
    ``workloads`` key lists the cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Mapping = None, root: Path = ROOT) -> Dict:
    """Everything one run of cell ``name`` needs: its entry, its
    configuration (the file's contents), its traffic (the file's
    contents) and the names of the metrics it reports."""
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return {"name": name, "chips": entry["chips"], "config": config,
            "traffic": traffic,
            "end_to_end": [m["name"] for m in bench["end_to_end"]
                           if applies(m, name)],
            "end_to_end_units": {m["name"]: m["unit"]
                                 for m in bench["end_to_end"]},
            "per_layer": [m["name"] for m in bench["per_layer"]
                          if applies(m, name)],
            "per_layer_units": {m["name"]: m["unit"]
                                for m in bench["per_layer"]}}


def driver(traffic: Mapping):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def reader(metric: str):
    return importlib.import_module(f"portbench.metrics.{metric}")

