"""The port's spans (``repro_torch.tracing``) over CPU sweeps.

Tracing is off by default and then records nothing.  On, a torch-engine
sweep of the paper's Cholesky (``apps/cholesky.py`` at n 512, the six
Fig. 9 designs at 1..8 slots, with and without the SMP) records spans
that nest inside their parents on the ``time.time_ns()`` clock, one
``step_loop`` per ``_scan_cohorts`` call, and one ``replay.exact`` per
exact run whose ``cause`` counts agree with the sweep's ``BatchStats``.
"""
import collections
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch import tracing
from repro_torch.apps import cholesky as ch
from repro_torch.core import Explorer, a9_smp_seconds, torchsim
from repro_torch.core import replay
from repro_torch.core.replay import BatchStats, ReplayLibrary

from own_order_common import cholesky_candidates

#: ``replay.exact`` causes and the ``BatchStats`` counter of each.
CAUSES = {"discover": "reference_lanes", "pinned": "order_pinned_lanes",
          "small_group": "small_group_lanes",
          "fallback": "serial_fallback_lanes"}

SWEEP_CHILDREN = {"sweep.prepare", "sweep.assemble", "sweep.schedules",
                  "sweep.save_orders", "replay.exact", "step_loop"}


@pytest.fixture(autouse=True)
def one_thread():
    """The step loop's tensors are small: one intra-op thread runs them
    about as fast and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def cholesky():
    """The trace, the reports and ``(slots, candidate)`` pairs: each
    Fig. 9 design at 1..8 slots a pool, with the SMP and FPGA only (the
    SMP kept where a kernel has nothing else)."""
    return (ch.trace_cholesky(n=512, bs=64), ch.report_map(bs=64),
            cholesky_candidates())


def sweep(cholesky, library=None, slots=8, prune=False, **kw):
    """One traced sweep; returns ``(records, batch stats, t0, t1)``, the
    two ``time.time_ns()`` reads taken around it."""
    trace, reports, cands = cholesky
    ex = Explorer(trace, reports, engine="torch", device="cpu",
                  smp_seconds_fn=a9_smp_seconds("float64"),
                  order_library=library, **kw)
    mine = [c for k, c in cands if k <= slots]
    tracing.reset()
    tracing.enable()
    t0 = time.time_ns()
    ex.explore(mine, top_k=3, prune=prune)
    t1 = time.time_ns()
    tracing.disable()
    return tracing.snapshot(), ex.batch_stats.as_dict(), t0, t1


def exact_causes(records):
    return collections.Counter(a.get("cause") for name, a, *_ in records
                               if name == "replay.exact")


def test_off_by_default_in_a_fresh_process():
    code = ("from repro_torch import tracing\n"
            "assert tracing.span('x') is tracing.NOOP\n"
            "with tracing.span('x') as sp:\n"
            "    sp.set(cause='discover')\n"
            "assert tracing.snapshot() == []\n")
    src = Path(tracing.__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(src)}, timeout=120)


def test_off_records_nothing_over_a_sweep(cholesky):
    trace, reports, cands = cholesky
    ex = Explorer(trace, reports, engine="torch", device="cpu",
                  smp_seconds_fn=a9_smp_seconds("float64"))
    ex.explore([c for _, c in cands[:12]], top_k=3)
    assert tracing.span("sweep") is tracing.NOOP
    assert tracing.snapshot() == []


def test_spans_nest_on_the_wall_clock(cholesky):
    records, _, t0, t1 = sweep(cholesky)
    names = collections.Counter(r[0] for r in records)
    assert names["sweep"] == 1
    for name in ("sweep.prepare", "sweep.assemble", "sweep.schedules",
                 "sweep.save_orders", "step_loop", "step.stage",
                 "step.run", "step.readback", "step.classify",
                 "replay.exact"):
        assert names[name] >= 1, name
    tid = records[0][4]
    for name, attrs, a, b, thread, parent in records:
        assert t0 <= a <= b <= t1
        assert thread == tid
        if name == "sweep":
            assert parent == -1
            continue
        pname, _, pa, pb, pthread, _ = records[parent]
        assert pa <= a and b <= pb and pthread == thread
        if name in SWEEP_CHILDREN:
            assert pname == "sweep", name
        elif name == "graph.build":
            assert pname == "sweep.prepare"
        elif name == "step.readback":
            assert pname == "step.run"
        else:
            assert pname == "step_loop", name


@pytest.mark.parametrize("torch_chunk", [None, 8],
                         ids=["megabatch", "chunk8"])
def test_own_order_tables_nest_inside_the_step_loop(cholesky, torch_chunk,
                                                   monkeypatch):
    """Each own-order cohort's tables are staged inside a ``step.tables``
    span, a child of ``step_loop`` beside ``step.stage``, before the
    cohort's slices run; groups under ``MIN_LOCKSTEP`` (4 slot counts)
    step their own orders.  (Tables are staged where the device cache
    lacks a call's blocks: here it starts empty.)"""
    monkeypatch.setattr(torchsim, "_DEV_XS_CACHE", collections.OrderedDict())
    records, stats, *_ = sweep(cholesky, slots=4, torch_chunk=torch_chunk)
    assert stats["own_order_lanes"] > 0
    tables = [(i, r) for i, r in enumerate(records) if r[0] == "step.tables"]
    assert tables
    for i, (_, _, a, b, _, parent) in tables:
        pname, _, pa, pb, _, _ = records[parent]
        assert pname == "step_loop" and pa <= a <= b <= pb
        runs = [r for r in records[i + 1:] if r[0] == "step.run"
                and r[5] == parent]
        assert runs and all(r[2] >= b for r in runs)


def test_one_step_loop_span_per_scan(cholesky, monkeypatch):
    calls = []
    scan = torchsim._scan_cohorts

    def counted(*args, **kwargs):
        calls.append(1)
        return scan(*args, **kwargs)

    monkeypatch.setattr(torchsim, "_scan_cohorts", counted)
    for torch_chunk in (None, 8):
        calls.clear()
        records, *_ = sweep(cholesky, torch_chunk=torch_chunk)
        loops = sum(1 for r in records if r[0] == "step_loop")
        assert calls and loops == len(calls)


@pytest.mark.parametrize("torch_chunk", [None, 8],
                         ids=["megabatch", "chunk8"])
@pytest.mark.parametrize("case", ["warm", "small_group", "fallback"])
def test_exact_spans_count_as_batch_stats(cholesky, case, torch_chunk):
    """Each cause's ``replay.exact`` spans equal its ``BatchStats``
    counter, sweep by sweep: a cold sweep, then two warm ones, then
    pruned ones on the same library, until the library's pins run on the
    exact path (a pruned sweep pins what it discovers in the second and
    runs it in the third), sweeps of groups under ``MIN_LOCKSTEP`` (4
    slot counts), and with no discovery rounds.  The
    second warm sweep's diverged lanes, and the last two causes' lanes,
    step their own orders on the lane axis (``own_order_lanes``); pinned,
    small-group and fallback lanes reach the exact path only under
    pruning, which keeps the routing without the own-order seam (a run
    the cutoff retired has no cause).  Each case runs at the default slice
    width and in slices of 8 lanes."""
    kw = {"torch_chunk": torch_chunk}
    if case == "warm":
        lib = ReplayLibrary()
        pruned = [False] * 3 + [True] * 3
        runs = [sweep(cholesky, lib, prune=p, **kw) for p in pruned]
    else:
        extra = {"slots": 4} if case == "small_group" \
            else {"max_rescue_rounds": 0}
        pruned = [False, True]
        runs = [sweep(cholesky, prune=p, **extra, **kw) for p in pruned]
    seen = collections.Counter()
    for (records, stats, _, _), p in zip(runs, pruned):
        got = exact_causes(records)
        assert set(got) <= set(CAUSES) | ({None} if p else set())
        for cause, counter in CAUSES.items():
            assert got[cause] == stats[counter], (cause, got, stats)
        seen.update(got)
    want = {"warm": {"discover"}, "small_group": {"small_group"},
            "fallback": {"fallback"}}[case]
    assert want <= set(seen)
    if case != "warm":
        records, stats, _, _ = runs[0]
        assert not want & set(exact_causes(records))
        assert stats["own_order_lanes"] > 0
    else:
        # the lanes that diverged in the second sweep step their own
        # orders in the third; pruning runs the library's pins serially
        assert runs[2][1]["own_order_lanes"] > 0
        assert seen["pinned"] > 0


def test_disable_stops_and_reset_clears(cholesky):
    records, *_ = sweep(cholesky, slots=2)
    assert records
    with tracing.span("after"):
        pass
    assert tracing.snapshot() == records
    tracing.reset()
    assert tracing.snapshot() == []


@pytest.mark.parametrize("cause", sorted(CAUSES))
@pytest.mark.parametrize("counted", [True, False], ids=["stats", "no_stats"])
def test_note_sets_the_cause_and_its_counter(cause, counted):
    """``replay._note`` gives the span its cause and adds one to that
    cause's ``BatchStats`` counter, and to no other."""
    stats = BatchStats() if counted else None
    tracing.enable()
    with tracing.span("replay.exact") as sp:
        pass
    replay._note(stats, sp, cause)
    assert tracing.snapshot()[0][1] == {"cause": cause}
    if counted:
        want = dict(BatchStats().as_dict(), **{CAUSES[cause]: 1})
        assert stats.as_dict() == want
    replay._note(stats, tracing.NOOP, cause)       # tracing off: a no-op
    if counted:
        assert getattr(stats, CAUSES[cause]) == 2


def test_attributes_and_open_spans():
    tracing.enable()
    with tracing.span("outer", a=1) as outer:
        outer.set(b=2)
        with tracing.span("inner"):
            open_now = tracing.snapshot()
    records = tracing.snapshot()
    assert [r[0] for r in records] == ["outer", "inner"]
    assert records[0][1] == {"a": 1, "b": 2} and records[0][5] == -1
    assert records[1][5] == 0
    assert [r[3] is None for r in open_now] == [True, True]
    tracing.reset()
    with tracing.span("after_reset"):
        pass
    assert [(r[0], r[5]) for r in tracing.snapshot()] == [("after_reset",
                                                           -1)]


def test_threads_keep_their_own_nesting():
    """Eight threads nest spans with the interpreter switching every few
    microseconds: no record is lost and each parent is on its thread."""
    tracing.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with tracing.span("a"):
                    with tracing.span("b"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    records = tracing.snapshot()
    assert len(records) == 8 * 200 * 2
    for name, _, a, b, tid, parent in records:
        if name == "a":
            assert parent == -1
        else:
            pname, _, pa, pb, ptid, _ = records[parent]
            assert (pname, ptid) == ("a", tid) and pa <= a <= b <= pb

