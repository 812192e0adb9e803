"""The readers of the port's own spans (``run["spans"].program``, the
records of ``repro_torch.tracing``): each on a run record made by hand,
None where the record has no program spans (an untraced run, or spans
that took none, as a program without the tracer gives), the innermost
span at an instant, and the readers over a CPU window of real sweeps."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from portbench.program_spans import innermost_at
from portbench.spans import Spans
from portbench.tests.helpers import small_cell

READERS = ("exact_path_share", "discovery_share", "schedules_share",
           "step_stage_share")

S = 1_000_000_000       # ns


def rec(name, t0, t1, parent=-1, **attrs):
    return (name, attrs, t0, t1, 1, parent)


#: One 4 s sweep: 1 s of schedules, exact runs of 0.5 s (discovery) and
#: 0.25 s (pinned), a 2 s step loop with 0.5 s of staging and two
#: slices' runs, and a span still open.
PROGRAM = [
    rec("sweep", 0, 4 * S),
    rec("replay.exact", S // 10, S // 10 + S // 2, 0, cause="discover"),
    rec("replay.exact", S, S + S // 4, 0, cause="pinned"),
    rec("step_loop", S + S // 2, 3 * S + S // 2, 0),
    rec("step.stage", S + S // 2, 2 * S, 3),
    rec("step.run", 2 * S, 2 * S + S // 2, 3),
    rec("step.run", 3 * S, 3 * S + S // 4, 3),
    rec("sweep.schedules", 3 * S + S // 2, 4 * S, 0),
    rec("sweep", 5 * S, None),
]

WANT = {"exact_path_share": 18.75, "discovery_share": 12.5,
        "schedules_share": 12.5, "step_stage_share": 25.0}


def reader(name):
    from portbench import registry
    return registry.reader(name).read


def run(program=None, spans=True):
    s = None
    if spans:
        s = Spans("cuda")
        if program is not None:
            s.program = program
    return {"answers": [], "spans": s, "devtrace": None,
            "counters": {"launches": 0, "shapes": {},
                         "cache": {"captures": 0}}}


@pytest.mark.parametrize("name", READERS)
def test_reader_value(name):
    assert reader(name)(run(PROGRAM)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("record", [
    run(spans=False), run(), run([]),
    run([rec("step.run", 0, S)])],
    ids=["untraced", "no_program", "empty", "no_sweep_or_loop"])
@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing(name, record):
    assert reader(name)(record) is None


@pytest.mark.parametrize("t,want", [
    (2 * S + S // 10, "step.run"), (S + S // 2, "step.stage"),
    (2 * S + 3 * S // 4, "step_loop"), (S // 5, "replay.exact"),
    (3 * S + 3 * S // 4, "sweep.schedules"), (S + S // 3, "sweep"),
    (4 * S, None), (6 * S, None)])
def test_innermost_span_at(t, want):
    assert innermost_at(PROGRAM, t) == want


def test_readers_over_a_cpu_window_of_sweeps():
    """Real records: the warm mix's sweeps on the CPU with the port's
    tracer on read a share of each."""
    from portbench import harness, registry
    from repro_torch import tracing
    ctx = harness.context(small_cell("cholesky512_sweep_warm"),
                          2 ** 31 + 3, "cpu")
    drv = registry.driver(ctx.traffic)
    drv.setup(ctx)
    tracing.reset()
    tracing.enable()
    try:
        t0 = time.perf_counter()
        answers = drv.window(ctx, 0.3, t0)
    finally:
        tracing.disable()
        drv.close(ctx)
    record = dict(run(tracing.snapshot()), answers=answers)
    tracing.reset()
    assert answers and all(a["ok"] for a in answers)
    got = {m: reader(m)(record) for m in READERS}
    for m in READERS:
        assert 0.0 <= got[m] <= 100.0, (m, got)
    assert got["exact_path_share"] > 0.0
    assert got["discovery_share"] <= got["exact_path_share"]
    assert got["step_stage_share"] > 0.0
