"""Every cell of BENCHMARK.json resolves to its files by name, and a cell,
a mix or a metric added as files alone is found."""
from __future__ import annotations

import json
import shutil

import pytest

from portbench.tests.helpers import ROOT


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(name):
    from portbench import apps, registry
    cell = registry.cell(name)
    assert registry.driver(cell["traffic"]).setup
    assert apps.load(cell["config"]).events(cell["config"])
    assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert registry.reader(m).read


def test_every_piece_has_its_file():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
    for m in b["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_cell_added_as_files_only_is_found(tmp_path, monkeypatch):
    from portbench import metrics, registry
    b = bench()
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    shutil.copy(ROOT / "portbench/configs/cholesky512_bs64.json",
                tmp_path / "portbench/configs/cholesky256_bs64.json")
    conf = json.loads((tmp_path / "portbench/configs/cholesky256_bs64.json")
                      .read_text())
    conf.update(name="cholesky256_bs64", n=256)
    (tmp_path / "portbench/configs/cholesky256_bs64.json").write_text(
        json.dumps(conf))
    (tmp_path / "portbench/traffic/sweep_warm_top1.json").write_text(
        json.dumps({"driver": "sweep", "library": "warm", "top_k": 1,
                    "warmup_sweeps": 1, "min_lockstep_share": 0,
                    "trace_at": 1.0,
                    "trace_seconds": 0.2}))
    mdir = tmp_path / "extra_metrics"
    mdir.mkdir()
    (mdir / "sweeps_answered.py").write_text(
        "def read(run):\n    return float(len(run['answers']))\n")
    monkeypatch.setattr(metrics, "__path__", list(metrics.__path__)
                        + [str(mdir)])
    b["configs"].append({"name": "cholesky256_bs64", "source": "x",
                         "file": "portbench/configs/cholesky256_bs64.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "cholesky256_sweep_top1",
                           "config": "cholesky256_bs64",
                           "traffic": "sweep_warm_top1", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "sweeps_answered", "unit": "sweeps",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "cand_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = registry.cell("cholesky256_sweep_top1", root=tmp_path)
    assert cell["config"]["n"] == 256 and cell["traffic"]["top_k"] == 1
    assert "sweeps_answered" in cell["per_layer"]
    assert registry.reader("sweeps_answered").read({"answers": [1, 2]}) == 2
    from portbench import apps
    # four tile columns: 4 dpotrf, 6 dtrsm, 6 dsyrk and 4 dgemm tasks
    assert len(apps.load(cell["config"]).events(cell["config"])) == 20
