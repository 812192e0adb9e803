"""Each per-layer reader on a run record made by hand: the value it
reads, and None where it finds nothing to read."""
from __future__ import annotations

import pytest

from portbench.spans import Spans


class Event:
    """A CUDA event's stand-in: its time on the device, in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def spans(step_loop=(), explore=(), events=()):
    s = Spans("cuda")
    s.spans = {"explore": list(explore), "step_loop": list(step_loop)}
    s.events = [(Event(a), Event(b)) for a, b in events]
    return s


def answer(t1, lanes=10, lockstep=4, ok=True):
    return {"t0": 0.0, "t1": t1, "ok": ok, "expected": [{}] * lanes,
            "batch_stats": {"lockstep_lanes": lockstep,
                            "reference_lanes": 1}}


def run(**kw):
    base = {"answers": [answer(2.0)], "spans": None, "devtrace": None,
            "counters": {"launches": 0, "shapes": {},
                         "cache": {"captures": 0}}}
    base.update(kw)
    return base


def reader(name):
    from portbench import registry
    return registry.reader(name).read


@pytest.mark.parametrize("events,want", [
    ([(0.0, 500.0)], 75.0),
    ([(0.0, 500.0), (600.0, 1600.0)], 25.0),
    ([(0.0, 2000.0)], 0.0)])
def test_device_idle_from_the_events(events, want):
    got = reader("device_idle_pct")(run(spans=spans(events=events)))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("record", [run(), run(spans=spans())],
                         ids=["untraced", "no_events"])
def test_device_idle_reads_nothing(record):
    assert reader("device_idle_pct")(record) is None


def test_lockstep_share_counts_answered_sweeps():
    r = run(answers=[answer(1.0, 10, 4), answer(2.0, 30, 6),
                     answer(3.0, 50, 0, ok=False)])
    assert reader("lockstep_lane_share")(r) == pytest.approx(25.0)
    assert reader("lockstep_lane_share")(
        run(answers=[answer(1.0, ok=False)])) is None


def test_explore_host_share_and_steps_per_s():
    s = spans(explore=[(0, 4_000_000_000)],
              step_loop=[(0, 1_000_000_000), (2_000_000_000, 3_000_000_000)])
    r = run(spans=s, counters={"launches": 5000, "shapes": {},
                               "cache": {"captures": 0}})
    assert reader("explore_host_share")(r) == pytest.approx(50.0)
    assert reader("steps_per_s")(r) == pytest.approx(2500.0)
    assert reader("explore_host_share")(run()) is None
    assert reader("steps_per_s")(run(spans=s)) is None


def test_roofline_reads_nothing_without_a_trace():
    r = run(counters={"launches": 1, "shapes": {(4, 16, 64): 1},
                      "cache": {"captures": 0}})
    assert reader("step_commit_roofline_pct")(r) is None
    dt = {"ops": {"step_commit_kernel": (0, 0.0)}}
    assert reader("step_commit_roofline_pct")(dict(r, devtrace=dt)) is None


def test_roofline_from_bytes_and_time():
    from portbench.roofline import HBM_BYTES_PER_S, commit_bytes
    t = commit_bytes(16, 64, 0) / HBM_BYTES_PER_S * 4   # a quarter
    r = run(counters={"launches": 2, "shapes": {(4, 16, 64): 2},
                      "cache": {"captures": 0}},
            devtrace={"ops": {"step_commit": (10, 10 * t)}})
    assert reader("step_commit_roofline_pct")(r) == pytest.approx(25.0)


def test_window_graph_captures():
    r = run(counters={"launches": 0, "shapes": {}, "cache": {"captures": 3}})
    assert reader("window_graph_captures")(r) == 3.0


@pytest.mark.parametrize("need,ok", [(0, True), (40, True), (41, False)])
def test_a_sweep_below_its_lockstep_share_fails(need, ok, monkeypatch):
    """40 of 100 lanes in lockstep meet a share of 40 %, not 41 %."""
    import importlib
    from types import SimpleNamespace

    from portbench.drivers import sweep
    explore = importlib.import_module("repro_torch.core.explore")

    class Stats:
        def as_dict(self):
            return {"lockstep_lanes": 40, "reference_lanes": 0}

    class FakeExplorer:
        engine = "torch"

        def __init__(self, *a, **kw):
            self.batch_stats = Stats()

        def explore(self, cands, top_k, prune=False):
            outs = [SimpleNamespace(name=str(c), makespan_s=1.0,
                                    status="ok") for c in cands]
            return SimpleNamespace(ranked=outs, outcomes=outs)

    monkeypatch.setattr(explore, "Explorer", FakeExplorer)
    ctx = SimpleNamespace(
        library=None, space=[{"name": str(i)} for i in range(100)],
        cands=list(range(100)), trace=None, reports=None, device="cpu",
        smp_fn=None, config={"fabric_budget": {}},
        traffic={"top_k": 3, "min_lockstep_share": need},
        synchronize=lambda: None)
    ans = sweep.sweep(ctx, list(range(100)), 0.0)
    assert ans["ok"] is ok
    assert sweep.sweep(ctx, list(range(100)), 0.0, min_share=0.0)["ok"]
