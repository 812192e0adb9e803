"""The port's dry-run (``repro_torch.launch.dryrun``), analytic traffic
floor (``repro_torch.roofline.analytic``) and roofline over the records
(``analyze_record``/``analyze_all``), against the JAX package's:

* ``collective_bytes`` gives JAX's operand, wire and count figures for the
  collectives JAX's HLO parser reads from the same ops;
* ``min_traffic_bytes`` and ``analyze_record`` equal JAX's, exactly, on the
  same records at the same ``HW`` values, for every kind; under 16
  devices, where JAX divides by zero, the port raises ``ValueError``;
* in one fresh interpreter (the ``fake`` process group is process-wide):
  smoke configs of one arch a family (dense qwen3-0.6b, MoE mixtral,
  hybrid zamba2, encoder-decoder whisper) × each step kind on a fake
  ``(2, 2)`` mesh give records with every key of JAX's record
  (``repro/launch/dryrun.py:243-265``); a pure-DP ``(4, 1)`` train
  record's all-reduce operand bytes are the gradient bytes plus one f32
  scalar (the loss's label count); the probes' linear extrapolation
  (``extrapolate_terms``) equals a 4-layer count within 1e-9 relative; a
  16×16 prefill with its two probes, written under a scratch
  ``ARTIFACTS``, reads back through ``analyze_all`` into a roofline
  table whose row equals JAX's ``analyze_record`` of the same records.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.dryrun import collective_bytes as jax_collective_bytes
from repro.roofline import analytic as janalytic
from repro.roofline import model as jmodel

from repro_torch.launch.dryrun import collective_bytes
from repro_torch.roofline import analytic, model

REPO = Path(__file__).resolve().parents[1]

#: Every key of the JAX package's record (``dryrun.py:243-265``).
JAX_KEYS = {"arch", "shape", "mesh", "kind", "n_devices", "plan", "tag",
            "seq_len", "global_batch", "n_layers", "full_n_layers",
            "params", "active_params", "lower_s", "compile_s",
            "cost_analysis", "collectives", "memory"}
JAX_SUBKEYS = {
    "plan": {"fsdp", "remat", "moment_dtype", "accum_steps",
             "seq_shard_cache", "notes"},
    "collectives": {"per_op_bytes", "per_op_counts", "per_op_wire_bytes",
                    "total_bytes", "wire_bytes"},
    "memory": {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "peak_memory_in_bytes", "generated_code_size_in_bytes"},
    "cost_analysis": {"flops", "bytes accessed"}}

HLO = """
ENTRY %main {
  %all-reduce.1 = f32[16,512]{1,0} all-reduce(%fusion.1), channel_id=1, replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[256,1024]{1,0} all-gather(%shard), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[4,128]{1,0} reduce-scatter(%big), channel_id=3, replica_groups=[64,4]<=[256], to_apply=%add
  %a2a = bf16[8,64]{1,0} all-to-all(%y), channel_id=5, replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = bf16[8,8]{1,0} collective-permute(%x), channel_id=4, source_target_pairs={{0,1},{1,0}}
}
"""


def test_collective_bytes_equal_jax_parser():
    """The events a rank's collectives give (the operand it hands in:
    the all-gather's shard, the reduce-scatter's whole tensor) against
    the same ops as JAX's parser reads them from HLO."""
    events = [("all-reduce", 16 * 512 * 4, 16),
              ("all-gather", 256 * 1024 * 2 // 16, 16),
              ("reduce-scatter", 4 * 128 * 4 * 4, 4),
              ("all-to-all", 8 * 64 * 2, 8),
              ("collective-permute", 8 * 8 * 2, 1)]
    assert collective_bytes(events) == jax_collective_bytes(HLO)
    with pytest.raises(ValueError, match="unknown collective"):
        collective_bytes([("broadcast", 4, 2)])


def _rec(kind, arch, n_dev=256, gb=32, seq=4096, params=596_049_920):
    return {"arch": arch, "shape": f"{kind}_cell", "mesh": "data=16×model=16",
            "kind": kind, "n_devices": n_dev, "tag": "", "n_layers": 28,
            "full_n_layers": 28, "seq_len": seq, "global_batch": gb,
            "params": params, "active_params": params // 2,
            "cost_analysis": {"flops": 1e13, "bytes accessed": 2e12},
            "collectives": {"wire_bytes": 3e9},
            "memory": {"peak_memory_in_bytes": 2_000_000_000}}


HW_PAIR = (jmodel.V5E, model.HW(name="tpu_v5e", peak_flops=197e12,
                                hbm_bw=819e9, link_bw=50e9, hbm_bytes=16e9))
ARCHS = ("qwen3-0.6b", "mixtral-8x22b", "zamba2-1.2b", "whisper-tiny",
         "llama4-maverick-400b-a17b", "rwkv6-1.6b")


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_floor_and_roofline_equal_jax(arch, kind):
    jhw, hw = HW_PAIR
    for n_dev, gb in ((256, 32), (512, 256), (16, 1), (32, 8)):
        rec = _rec(kind, arch, n_dev=n_dev, gb=gb)
        assert analytic.min_traffic_bytes(rec, hw) == \
            janalytic.min_traffic_bytes(rec, jhw)
        a = dataclasses.asdict(model.analyze_record(rec, hw))
        b = dataclasses.asdict(jmodel.analyze_record(rec, jhw))
        assert a == b
        probes = [dict(rec, n_layers=1, tag="probe1",
                       cost_analysis={"flops": 3e11, "bytes accessed": 4e10},
                       collectives={"wire_bytes": 1e8}),
                  dict(rec, n_layers=2, tag="probe2",
                       cost_analysis={"flops": 5e11, "bytes accessed": 7e10},
                       collectives={"wire_bytes": 2e8})]
        assert dataclasses.asdict(model.analyze_record(rec, hw, probes)) == \
            dataclasses.asdict(jmodel.analyze_record(rec, jhw, probes))


def test_traffic_floor_under_16_devices_raises():
    rec = _rec("train", "qwen3-0.6b", n_dev=4, gb=8)
    with pytest.raises(ZeroDivisionError):
        janalytic.min_traffic_bytes(rec)
    with pytest.raises(ValueError, match="at least 16 devices"):
        analytic.min_traffic_bytes(rec)


SCRIPT = r"""
import dataclasses, json, sys
from pathlib import Path
from repro_torch import configs
from repro_torch.configs import Shape
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.roofline import model as rmodel

out = Path(sys.argv[1])
res = {"cells": {}}
MESH = ((2, 2), ("data", "model"))
KINDS = {"train_4k": ("train", 4, 32), "prefill_32k": ("prefill", 4, 32),
         "decode_32k": ("decode", 4, 32)}


def cell(arch, shape, mesh=MESH, **kw):
    kind, b, t = KINDS[shape]
    kw.setdefault("save", False)
    return dryrun.run_cell(arch, shape, False, mesh_override=mesh,
                           device="cpu", smoke=True,
                           shape_override=Shape(shape, t, b, kind), **kw)


for arch in ("qwen3-0.6b", "mixtral-8x22b", "zamba2-1.2b", "whisper-tiny"):
    for shape in KINDS:
        res["cells"][f"{arch}/{shape}"] = cell(arch, shape)

# pure data parallelism: the gradients' all-reduce
rec = cell("qwen3-0.6b", "train_4k", mesh=((4, 1), ("data", "model")))
cfg = configs.get_smoke("qwen3-0.6b")
res["dp"] = {"record": rec, "grad_bytes": sum(
    p.numel() * p.element_size()
    for p in T.Transformer(cfg, device="meta").parameters())}

# the probes at 1 and 2 layers against a 4-layer count
res["probes"] = [cell("qwen3-0.6b", "train_4k", probe_layers=n,
                      cfg_overrides={"n_layers": 4}) for n in (1, 2)]
res["full4"] = cell("qwen3-0.6b", "train_4k", cfg_overrides={"n_layers": 4})

# a 16x16 prefill and its probes through the artifacts and analyze_all
dryrun.ARTIFACTS = out / "build" / "dryrun"
rmodel.ARTIFACTS = out / "build"
mesh16 = ((16, 16), ("data", "model"))
for probe in (None, 1, 2):
    kind, b, t = "prefill", 16, 32
    dryrun.run_cell("qwen3-0.6b", "prefill_32k", False, mesh_override=mesh16,
                    device="cpu", smoke=True, probe_layers=probe,
                    shape_override=Shape("prefill_32k", t, b, kind))
res["artifacts"] = rmodel.load_artifacts()
cells = rmodel.analyze_all()
res["table"] = rmodel.roofline_table(cells)
res["rows"] = [dataclasses.asdict(c) for c in cells]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
res["imported"] = bad
(out / "result.json").write_text(json.dumps(res))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", SCRIPT, str(out)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=str(REPO))
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads((out / "result.json").read_text())


CELLS = [f"{a}/{s}" for a in ("qwen3-0.6b", "mixtral-8x22b", "zamba2-1.2b",
                             "whisper-tiny")
         for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("name", CELLS)
def test_records_have_jax_keys(dry, name):
    rec = dry["cells"][name]
    assert JAX_KEYS <= set(rec)
    for key, sub in JAX_SUBKEYS.items():
        assert sub <= set(rec[key]), key
    c = rec["collectives"]
    assert c["total_bytes"] == sum(c["per_op_bytes"].values())
    assert rec["n_devices"] == 4 and rec["mesh"] == "data=2×model=2"
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["compile_s"] == 0.0 and rec["attn_impl"] == "chunked"
    assert c["wire_bytes"] > 0          # a 2x2 mesh moves something
    assert dry["imported"] == []


def test_pure_dp_all_reduce_is_the_gradients(dry):
    rec = dry["dp"]["record"]
    assert rec["mesh"] == "data=4×model=1"
    assert rec["collectives"]["per_op_bytes"]["all-reduce"] == \
        dry["dp"]["grad_bytes"] + 4
    assert rec["collectives"]["per_op_bytes"]["reduce-scatter"] == 0


def test_probe_extrapolation_equals_full_count(dry):
    p1, p2 = dry["probes"]
    full = dry["full4"]
    assert (p1["tag"], p2["tag"]) == ("probe1", "probe2")
    assert p1["full_n_layers"] == 4 and full["n_layers"] == 4
    terms = model.extrapolate_terms(p1, p2, 4)
    want = model._terms_of(full)
    for k, v in want.items():
        assert abs(terms[k] - v) <= 1e-9 * abs(v), (k, terms[k], v)


def test_analyze_all_reads_the_records_as_jax_does(dry):
    recs = dry["artifacts"]
    assert sorted(r["tag"] for r in recs) == ["", "probe1", "probe2"]
    full = next(r for r in recs if not r["tag"])
    probes = [r for r in recs if r["tag"]]
    jhw = jmodel.V5E
    hw = HW_PAIR[1]
    assert dataclasses.asdict(model.analyze_record(full, hw, probes)) == \
        dataclasses.asdict(jmodel.analyze_record(full, jhw, probes))
    (row,) = dry["rows"]
    assert row == dataclasses.asdict(model.analyze_record(
        full, model.H100, probes))
    assert dry["table"].count("\n") == 2
    assert "| qwen3-0.6b | prefill_32k | data=16×model=16 |" in dry["table"]
