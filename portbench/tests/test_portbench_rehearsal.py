"""A tiny ``--seconds`` rehearsal of every cell on the CPU gives the
result's keys and a correct verdict; the command refuses without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import CELLS, ROOT, cpu_run, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_result(name):
    r = cpu_run(small_cell(name), seed=2 ** 31 + 11)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"] and list(r)[-1] == "checks"
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    cell = small_cell(name)
    assert set(r["metrics"]) == set(cell["end_to_end"])
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["checks"]) == {"gap", "rank_errors", "missing"}
    json.dumps(r)


def test_same_seed_same_inputs():
    from portbench import harness
    a = harness.context(small_cell("cholesky512_sweep_warm"), 7, "cpu")
    b = harness.context(small_cell("cholesky512_sweep_warm"), 7, "cpu")
    assert a.inputs == b.inputs
    assert list(a.rng.permutation(50)) == list(b.rng.permutation(50))
    c = harness.context(small_cell("cholesky512_sweep_warm"), -5, "cpu")
    assert list(c.rng.permutation(50)) != list(a.rng.permutation(50))


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cholesky512_sweep_warm", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    (no ``src``): no result, a non-zero exit."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cholesky512_sweep_warm", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card(gpu):
    """One short run of the warm Cholesky cell on the card."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cholesky512_sweep_warm", "--seed", "5", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
