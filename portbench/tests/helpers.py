"""Helpers of the benchmark's CPU tests: cells resolved from their files,
with one warm-up sweep, so that the torch engine's CPU body runs them in
seconds."""
from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: The cells of BENCHMARK.json.
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

#: The configurations of BENCHMARK.json.
CONFIGS = [c["name"] for c in
           json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]]


def small_cell(name: str) -> dict:
    from portbench import registry
    cell = registry.cell(name)
    cell["traffic"] = dict(cell["traffic"], warmup_sweeps=1)
    return cell


def cpu_run(cell: dict, seed: int = 12345, seconds: float = 0.5) -> dict:
    from portbench import harness
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            time.perf_counter())
