"""The matmul configuration: its trace is the port's blocked matmul, its
reports the port's HLS model, its SMP the A9 at the single-precision
rate, and its design space every design of the three kinds that fits the
fabric, the paper's ``1acc64`` and ``2acc64`` among them, each with and
without the SMP.  Then the reader of ``own_order_lane_share``."""
from __future__ import annotations

import json

import pytest

from portbench.tests.helpers import ROOT

#: Each accelerator kind's unroll in the port's HLS model.
UNROLL = {"fpga:mxm64": 64, "fpga:mxm64r32": 32, "fpga:mxm64r16": 16}


def config():
    return json.loads(
        (ROOT / "portbench/configs/matmul512_bs64.json").read_text())


def space(conf=None):
    from portbench import apps
    conf = config() if conf is None else conf
    return apps.load(conf).design_space(conf)


def test_the_space_counts_67_designs_twice():
    s = space()
    assert len(s) == 134 == 2 * len({tuple(sorted(c["fabric"].items()))
                                     for c in s})
    assert len({c["name"] for c in s}) == len(s)


@pytest.mark.parametrize("n", [1, 2], ids=["1acc64", "2acc64"])
def test_the_papers_designs_are_in_the_space(n):
    """Fig. 5's ``{1,2}acc64``, each ``+smp`` and FPGA only."""
    hits = [c for c in space() if c["fabric"] == {"fpga:mxm64": n}]
    assert sorted(c["eligibility"]["mxm_block"] for c in hits) == \
        [["fpga:mxm64"], ["fpga:mxm64", "smp"]]


@pytest.mark.parametrize("smp", [True, False])
def test_eligibility_follows_the_smp_axis(smp):
    for c in space(dict(config(), smp_axis=[smp])):
        kinds = c["eligibility"]["mxm_block"]
        assert kinds[:len(c["fabric"])] == list(c["fabric"])
        assert kinds[len(c["fabric"]):] == (["smp"] if smp else [])


def test_events_are_the_ports_blocked_matmul():
    """The trace, event by event, is ``apps/matmul.py::trace_matmul(512,
    64)``: names, devices, work, the A9's time for it, and accesses, each
    region key standing for one of the port's buffers throughout."""
    from portbench import apps
    from repro_torch.apps.matmul import trace_matmul
    from repro_torch.core.hlsreport import A9_SGEMM_GFLOPS
    conf = config()
    assert conf["smp"] == {"model": "a9", "gflops": A9_SGEMM_GFLOPS}
    mine = apps.inputs(conf)["events"]
    theirs = trace_matmul(conf["n"], conf["bs"], conf["dtype"],
                          verify=False).events
    assert len(mine) == len(theirs) == 512
    keys = {}
    for a, b in zip(mine, theirs):
        assert (a["index"], a["name"], tuple(a["devices"]), a["flops"]) == \
            (b.index, b.name, tuple(b.devices), b.flops)
        assert a["elapsed_smp"] == b.flops / (A9_SGEMM_GFLOPS * 1e9)
        assert [(d, n) for _, d, n in a["accesses"]] == \
            [(d, n) for _, d, n in b.accesses]
        for (ka, _, _), (kb, _, _) in zip(a["accesses"], b.accesses):
            assert keys.setdefault(ka, kb) == kb
    assert len(set(keys.values())) == len(keys)


def test_reports_are_the_ports_hls_model():
    from repro_torch.core.hlsreport import HLSSynthesisModel, ZYNQ_7045_BUDGET
    conf = config()
    assert conf["fabric_budget"] == ZYNQ_7045_BUDGET
    hls = HLSSynthesisModel()
    assert [r["device_kind"] for r in conf["reports"]] == list(UNROLL)
    for r in conf["reports"]:
        want = hls.matmul_block(conf["bs"], dtype=conf["dtype"],
                                unroll=UNROLL[r["device_kind"]],
                                kind=r["device_kind"])
        assert r["kernel"] == "mxm_block"
        assert (r["compute_s"], r["dma_in_s"], r["dma_out_s"],
                r["resources"]) == (want.compute_s, want.dma_in_s,
                                    want.dma_out_s, want.resources)


def test_a_port_without_own_order_lanes_stops_before_setup(monkeypatch):
    """This port passes the deployment's gate; one whose ``BatchStats``
    has no ``own_order_lanes`` raises when the inputs are generated."""
    import dataclasses

    from portbench import apps
    from repro_torch.core import replay
    conf = config()
    assert len(apps.inputs(conf)["events"]) == 512
    Older = dataclasses.make_dataclass(
        "BatchStats", [(f.name, int, 0)
                       for f in dataclasses.fields(replay.BatchStats)
                       if f.name != "own_order_lanes"])
    monkeypatch.setattr(replay, "BatchStats", Older)
    with pytest.raises(RuntimeError, match="own-order lanes"):
        apps.inputs(conf)


def answer(lanes, own, ok=True, counted=True):
    stats = {"lockstep_lanes": own, "reference_lanes": 0}
    if counted:
        stats["own_order_lanes"] = own
    return {"t0": 0.0, "t1": 1.0, "ok": ok, "expected": [{}] * lanes,
            "batch_stats": stats}


def own_share(answers):
    from portbench import registry
    return registry.reader("own_order_lane_share").read(
        {"answers": answers, "spans": None, "devtrace": None,
         "counters": {}})


@pytest.mark.parametrize("answers,want", [
    ([answer(10, 9), answer(30, 30)], 97.5),
    ([answer(10, 9), answer(30, 0, ok=False)], 90.0),
    ([answer(10, 0, ok=False)], None),
    ([], None),
    ([answer(10, 9, counted=False)], None),
], ids=["two_sweeps", "failed_left_out", "none_answered", "no_answer",
        "no_counter"])
def test_own_order_lane_share(answers, want):
    got = own_share(answers)
    assert got == pytest.approx(want) if want is not None else got is None
