"""Direct assembly of ``FrozenGraph`` payloads from one trace analysis.

``TraceAnalysis.frozen_graph`` builds a graph key's payload straight from
what every graph of the trace shares.  It is held, field by field and bit
for bit, to ``FrozenGraph.freeze(build_graph(...))``, the definition: on
every graph key of the paper's Cholesky with the Fig. 9 kinds and of the
matmul, on random traces, and in the two errors ``build_graph`` raises.
An ``Explorer`` builds one analysis, on its first graph miss, and shares
it with no other; each miss is one ``graph.build`` span inside
``sweep.prepare``.  A structure walks its two longest paths once per
distinct row-cost vector, and ``CacheStats.graph_path_reuses`` counts the
builds that took them from its memo.
"""
import dataclasses
import gc
import importlib
import itertools

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

from repro_torch import tracing
from repro_torch.apps import cholesky as ch
from repro_torch.apps import matmul as mm
from repro_torch.core import a9_smp_seconds
from repro_torch.core.augment import (Eligibility, TraceAnalysis,
                                      build_graph, lower_bound_cost)
from repro_torch.core.devices import zynq_system
from repro_torch.core.diskcache import DiskCache
from repro_torch.core.fastsim import FrozenGraph
from repro_torch.core.hlsreport import HLSSynthesisModel, KernelReport
from repro_torch.core.trace import Trace, TraceEvent

explore_mod = importlib.import_module("repro_torch.core.explore")
Candidate, Explorer = explore_mod.Candidate, explore_mod.Explorer

ARRAYS = ("uid", "is_compute", "creation_index", "cond", "act_indptr",
          "act_kids", "dev_indptr", "dev_kids", "cost", "succ_indptr",
          "succ_rows", "n_pred")
VALUES = ("n", "names", "roles", "kinds", "stats", "critical_path_s",
          "lower_bound_s")


def assert_same_graph(direct: FrozenGraph, ref: FrozenGraph) -> None:
    for f in ARRAYS:
        a, b = getattr(direct, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b, equal_nan=f == "cost"), f
    for f in VALUES:
        assert getattr(direct, f) == getattr(ref, f), f
    assert direct.content_hash() == ref.content_hash()


# ---------------------------------------------------------------------------
# the apps' graph keys
# ---------------------------------------------------------------------------


def cholesky_keys():
    """Every design of the six Fig. 9 kinds (one slot each), each kernel
    on the kinds of it the design has, with and without the SMP, under
    both output-transfer models."""
    reports = ch.report_map(bs=64)
    kinds = sorted({k for _, k in reports})
    out = []
    for r in range(1, len(kinds) + 1):
        for design in itertools.combinations(kinds, r):
            for smp, overlap in itertools.product((True, False), repeat=2):
                m = {"dpotrf": ("smp",)}
                for op in ch.KERNELS:
                    acc = tuple(k for k in design if (op, k) in reports)
                    m[op] = acc + ("smp",) if smp or not acc else acc
                system = dataclasses.replace(
                    zynq_system("+".join(design), dict.fromkeys(design, 1)),
                    overlap_outputs=overlap)
                out.append((system, Eligibility(m)))
    return reports, out


@pytest.fixture(scope="module")
def cholesky_trace():
    return ch.trace_cholesky(n=256, bs=64)


def test_cholesky_fig9_keys_equal_the_definition(cholesky_trace):
    reports, keys = cholesky_keys()
    fn = a9_smp_seconds("float64")
    an = TraceAnalysis(cholesky_trace, smp_cost="mean", smp_seconds_fn=fn)
    for system, elig in keys:
        ref = FrozenGraph.freeze(build_graph(
            cholesky_trace, system, reports, elig, smp_cost="mean",
            smp_seconds_fn=fn))
        assert_same_graph(an.frozen_graph(system, reports, elig), ref)
    # a structure is kept per (accelerated kernels, output model) only
    assert len(an._structures) < len(keys)


def test_runtime_mirror_rows_leave_the_collector(cholesky_trace):
    """The plain-Python mirror ``simulate_fast`` runs on holds its rows'
    options, activated kinds, costs and successors as tuples of numbers,
    which the collector stops tracking: a sweep's mirrors bring on no
    full collection.  Each row's activated kinds are its ``act_kids``,
    sorted and unique."""
    reports, keys = cholesky_keys()
    system, elig = keys[-1]
    fg = FrozenGraph.freeze(build_graph(cholesky_trace, system, reports,
                                        elig))
    rt = fg._runtime()
    gc.collect()
    rows = [x for field in rt[4:8] for x in field]
    assert len(rows) == 4 * fg.n
    assert all(type(x) is tuple and not gc.is_tracked(x) for x in rows)
    for i in range(fg.n):
        acts = fg.act_kids[fg.act_indptr[i]:fg.act_indptr[i + 1]]
        assert rt[5][i] == tuple(sorted(set(acts.tolist())))


@pytest.mark.parametrize("bs", [64, 128])
def test_matmul_candidates_equal_the_definition(bs):
    trace = mm.trace_matmul(n=256, bs=bs)
    reports = mm.report_map()
    an = TraceAnalysis(trace, smp_cost="mean")
    for cand in mm.candidates()[bs]:
        ref = FrozenGraph.freeze(build_graph(
            trace, cand.system, reports, cand.eligibility, smp_cost="mean"))
        assert_same_graph(
            an.frozen_graph(cand.system, reports, cand.eligibility), ref)


# ---------------------------------------------------------------------------
# random traces
# ---------------------------------------------------------------------------

KERNELS = ("ka", "kb", "kc")
ACCEL = ("fpga:a", "fpga:b")


@st.composite
def random_case(draw):
    """A trace of three kernels over a few regions, with repeated and
    mixed accesses; random reports; each kernel on a random non-empty
    subset of two accelerator kinds and the SMP."""
    n = draw(st.integers(1, 24))
    n_regions = draw(st.integers(1, 4))
    events = []
    for i in range(n):
        accs = [((draw(st.integers(0, n_regions - 1)),),
                 draw(st.sampled_from(["in", "out", "inout"])),
                 draw(st.integers(0, 4096)))
                for _ in range(draw(st.integers(0, 3)))]
        events.append(TraceEvent(
            index=i, name=draw(st.sampled_from(KERNELS)),
            created_at=i * 1e-6,
            elapsed_smp=draw(st.floats(1e-5, 5e-3)), accesses=accs,
            devices=("fpga", "smp"), flops=draw(st.floats(1.0, 1e7))))
    reports = {(k, kind): KernelReport(
        kernel=k, device_kind=kind, compute_s=draw(st.floats(1e-6, 1e-3)),
        dma_in_s=draw(st.floats(0.0, 1e-4)),
        dma_out_s=draw(st.floats(0.0, 1e-4)))
        for k in KERNELS for kind in ACCEL}
    elig = {}
    for k in KERNELS:
        kinds = draw(st.lists(st.sampled_from(ACCEL + ("smp",)), min_size=1,
                              max_size=3, unique=True))
        elig[k] = tuple(kinds)
    slots = {kind: draw(st.integers(0, 2)) for kind in ACCEL}
    system = dataclasses.replace(
        zynq_system("r", slots,
                    task_creation_cost=draw(st.floats(0.0, 1e-5)),
                    dma_submit_cost=draw(st.floats(0.0, 1e-5))),
        overlap_inputs=draw(st.booleans()),
        overlap_outputs=draw(st.booleans()))
    # a kernel whose kinds the system lacks runs on the SMP
    avail = set(system.all_kinds())
    elig = {k: v if any(x in avail for x in v) else v + ("smp",)
            for k, v in elig.items()}
    return Trace(events=events, wall_seconds=1.0), reports, system, \
        Eligibility(elig)


def flops_seconds(ev):
    return ev.flops / 1.8e8


@hypothesis.given(random_case(), st.sampled_from(
    ["per_instance", "mean", "fn"]), st.sampled_from([1.0, 0.37, 2.5]))
@hypothesis.settings(deadline=None, max_examples=120)
def test_random_traces_equal_the_definition(case, smp_model, scale):
    trace, reports, system, elig = case
    smp = {"smp_seconds_fn": flops_seconds} if smp_model == "fn" \
        else {"smp_cost": smp_model, "smp_scale": scale}
    ref = FrozenGraph.freeze(build_graph(trace, system, reports, elig,
                                         **smp))
    direct = TraceAnalysis(trace, **smp).frozen_graph(system, reports, elig)
    assert_same_graph(direct, ref)


@st.composite
def odd_smp_case(draw):
    """A random case whose SMP model gives some events NaN, inf or −inf
    seconds, and in half the cases raises on some others."""
    trace, reports, system, elig = draw(random_case())
    modes = ["flops", "nan", "inf", "-inf"]
    if draw(st.booleans()):
        modes.append("raise")
    modes = draw(st.lists(st.sampled_from(modes), min_size=len(trace.events),
                          max_size=len(trace.events)))

    def fn(ev):
        mode = modes[ev.index]
        if mode == "raise":
            raise ArithmeticError(f"no model for event {ev.index}")
        return flops_seconds(ev) if mode == "flops" else float(mode)

    return trace, reports, system, elig, fn


@hypothesis.given(odd_smp_case())
@hypothesis.settings(deadline=None, max_examples=120)
def test_odd_smp_models_equal_the_definition(case):
    """NaN and infinite SMP costs, and a model that raises on some events
    only: the payload equals the definition's, longest paths included, or
    the same exception is raised."""
    trace, reports, system, elig, fn = case
    try:
        ref = FrozenGraph.freeze(build_graph(trace, system, reports, elig,
                                             smp_seconds_fn=fn))
    except ArithmeticError as want:
        with pytest.raises(ArithmeticError) as got:
            TraceAnalysis(trace, smp_seconds_fn=fn).frozen_graph(
                system, reports, elig)
        assert str(got.value) == str(want)
        return
    direct = TraceAnalysis(trace, smp_seconds_fn=fn).frozen_graph(
        system, reports, elig)
    assert_same_graph(direct, ref)


# ---------------------------------------------------------------------------
# the errors of build_graph
# ---------------------------------------------------------------------------


def refuse_dtrsm(ev):
    if ev.name == "dtrsm":
        raise ZeroDivisionError("no model for dtrsm")
    return 1e-4


@pytest.mark.parametrize("case", ["no_kind", "no_report", "smp_model"])
def test_errors_equal_the_definition(cholesky_trace, case):
    """No eligible kind present raises ``ValueError``, a missing report
    ``KeyError``, an SMP model that fails on an event its exception: the
    same type and message as ``build_graph``, whichever event is first,
    and a fresh exception on every call."""
    reports = ch.report_map(bs=64)
    fr = ch.hls_reports(bs=64)["dgemm"][True].device_kind
    system = zynq_system("s", {fr: 1})
    smp = {"smp_cost": "mean"}
    elig = Eligibility({"dgemm": (fr, "smp")})
    if case == "no_kind":
        elig = Eligibility({"dgemm": (fr,)}, default=("fpga:none",))
    elif case == "no_report":
        reports = {k: v for k, v in reports.items() if k[0] != "dgemm"}
    else:
        smp = {"smp_seconds_fn": refuse_dtrsm}
    with pytest.raises((ValueError, KeyError, ZeroDivisionError)) as want:
        build_graph(cholesky_trace, system, reports, elig, **smp)
    an = TraceAnalysis(cholesky_trace, **smp)   # the model fails lazily
    with pytest.raises(want.type) as got:
        an.frozen_graph(system, reports, elig)
    assert str(got.value) == str(want.value)
    with pytest.raises(want.type) as again:
        an.frozen_graph(system, reports, elig)
    assert again.value is not got.value


# ---------------------------------------------------------------------------
# the longest paths, once per cost vector
# ---------------------------------------------------------------------------

MATMUL_UNROLLS = {"fpga:mxm64": 64, "fpga:mxm64r32": 32, "fpga:mxm64r16": 16}


def matmul_space():
    """The paper's matmul at n 512, bs 64 (3,584 rows) under every set of
    three unrolls of the 64-block kernel, with and without the SMP: 14
    graph keys of one structure."""
    hls = HLSSynthesisModel()
    reports = {("mxm_block", kind): hls.matmul_block(64, unroll=u, kind=kind)
               for kind, u in MATMUL_UNROLLS.items()}
    cands = []
    for r in range(1, len(MATMUL_UNROLLS) + 1):
        for design in itertools.combinations(MATMUL_UNROLLS, r):
            for smp in (True, False):
                name = "+".join(design) + ("+smp" if smp else "")
                cands.append(Candidate(
                    name=name, system=zynq_system(name,
                                                  dict.fromkeys(design, 1)),
                    eligibility=Eligibility(
                        {"mxm_block": design + (("smp",) if smp else ())})))
    return mm.trace_matmul(n=512, bs=64), reports, cands, \
        a9_smp_seconds("float32")


def fig9_space(trace):
    reports, keys = cholesky_keys()
    cands = [Candidate(name=f"key{i}", system=system, eligibility=elig)
             for i, (system, elig) in enumerate(keys)]
    return trace, reports, cands, a9_smp_seconds("float64")


@pytest.mark.parametrize("app", ["matmul", "cholesky"])
def test_path_memo_is_exact(app, cholesky_trace):
    """Every graph key of the space is built once by an Explorer: each
    payload equals the definition, and the builds whose longest paths came
    from the memo are the keys less the distinct (structure, row costs,
    row lower-bound costs) the definition's graphs hold."""
    trace, reports, cands, fn = matmul_space() if app == "matmul" \
        else fig9_space(cholesky_trace)
    ex = Explorer(trace, reports, engine="batch", smp_seconds_fn=fn)
    assert ex.stats.graph_path_reuses == 0
    ex.explore(cands, top_k=3)
    keys = {explore_mod._graph_key(c.system, c.eligibility): c
            for c in cands}
    assert ex.stats.graph_misses == len(keys) == len(cands)
    triples = set()
    for key, c in keys.items():
        g = build_graph(trace, c.system, reports, c.eligibility,
                        smp_cost="mean", smp_seconds_fn=fn)
        ref = FrozenGraph.freeze(g)
        assert_same_graph(ex._graphs[key][0], ref)
        triples.add(((ref.names, ref.cond.tobytes(),
                      ref.succ_indptr.tobytes(), ref.succ_rows.tobytes()),
                     tuple(min(t.costs.values()) for t in g.tasks.values()),
                     tuple(lower_bound_cost(t) for t in g.tasks.values())))
    assert ex.stats.graph_path_reuses == len(keys) - len(triples) > 0
    if app == "matmul":         # the fastest kind present sets each row
        assert len(triples) == 3


def test_other_costs_of_one_structure_walk_other_paths():
    """Two keys of one structure whose rows cost differently: neither
    takes the other's longest paths."""
    trace, reports, cands, fn = matmul_space()
    fast, slow = (next(c for c in cands if c.name == name)
                  for name in ("fpga:mxm64", "fpga:mxm64r16"))
    an = TraceAnalysis(trace, smp_cost="mean", smp_seconds_fn=fn)
    got = [an.assemble(c.system, reports, c.eligibility) for c in
           (fast, slow, fast)]
    assert len(an._structures) == 1
    assert [reused for _, reused in got] == [False, False, True]
    assert got[0][0].critical_path_s < got[1][0].critical_path_s
    assert got[0][0].lower_bound_s < got[1][0].lower_bound_s
    assert got[2][0].critical_path_s == got[0][0].critical_path_s
    for c, (fg, _) in zip((fast, slow), got):
        assert_same_graph(fg, FrozenGraph.freeze(build_graph(
            trace, c.system, reports, c.eligibility, smp_cost="mean",
            smp_seconds_fn=fn)))


# ---------------------------------------------------------------------------
# inside the Explorer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep_case(cholesky_trace):
    """The Fig. 9 designs at 1..3 slots a pool, with and without the
    SMP: 36 candidates over 12 graph keys."""
    cands = []
    for base in ch.candidates(bs=64):
        fpga_only = Eligibility({
            op: tuple(d for d in kinds if d != "smp") or kinds
            for op, kinds in base.eligibility.kinds_by_kernel.items()})
        for k in range(1, 4):
            counts = {kind: n * k for kind, n
                      in base.system.meta["accelerators"].items()}
            for smp in (True, False):
                name = f"{base.name}x{k}{'' if smp else '-fpga'}"
                cands.append(Candidate(
                    name=name, system=zynq_system(name, counts),
                    eligibility=base.eligibility if smp else fpga_only))
    return cholesky_trace, ch.report_map(bs=64), cands


def explorer(sweep_case, **kw):
    trace, reports, _ = sweep_case
    kw.setdefault("engine", "batch")
    return Explorer(trace, reports, smp_seconds_fn=a9_smp_seconds("float64"),
                    **kw)


def test_one_analysis_per_explorer(sweep_case, monkeypatch):
    made = []

    class Counted(TraceAnalysis):
        def __init__(self, *args, **kwargs):
            made.append(self)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(explore_mod, "TraceAnalysis", Counted)
    cands = sweep_case[2]
    first = explorer(sweep_case)
    first.explore(cands, top_k=3)
    reuses = first.stats.graph_path_reuses
    assert 0 < reuses < 12
    first.explore(cands, top_k=3)
    assert len(made) == 1 and first.stats.graph_misses == 12
    assert first.stats.graph_path_reuses == reuses    # hits build nothing
    second = explorer(sweep_case)
    assert second.stats.graph_path_reuses == 0
    second.explore(cands, top_k=3)
    # nothing carried over: the second builds its own, and every graph,
    # and walks every longest path the first walked
    assert len(made) == 2 and made[0] is not made[1]
    assert second.stats.graph_misses == first.stats.graph_misses
    assert second.stats.graph_hits == len(cands) - 12
    assert second.stats.graph_path_reuses == reuses
    assert not {id(x) for x in made[0]._structures.values()} & \
        {id(x) for x in made[1]._structures.values()}


@pytest.mark.parametrize("engine,prune", [("batch", False), ("batch", True),
                                          ("torch", False)])
def test_graph_build_spans_count_the_misses(sweep_case, engine, prune):
    kw = {"device": "cpu"} if engine == "torch" else {}
    ex = explorer(sweep_case, engine=engine, **kw)
    tracing.reset()
    tracing.enable()
    try:
        ex.explore(sweep_case[2], top_k=3, prune=prune)
    finally:
        tracing.disable()
    records = tracing.snapshot()
    tracing.reset()
    builds = [r for r in records if r[0] == "graph.build"]
    assert len(builds) == ex.stats.graph_misses > 0
    for name, _, t0, t1, _, parent in builds:
        assert records[parent][0] == "sweep.prepare"
        assert records[parent][2] <= t0 <= t1 <= records[parent][3]


def test_batch_ranks_as_the_reference(sweep_case):
    cands = sweep_case[2]
    got = explorer(sweep_case).explore(cands, top_k=3)
    want = explorer(sweep_case, engine="reference").explore(cands, top_k=3)
    assert [(o.name, o.makespan_s, o.critical_path_s, o.lower_bound_s)
            for o in got.ranked] == \
        [(o.name, o.makespan_s, o.critical_path_s, o.lower_bound_s)
         for o in want.ranked]


def test_disk_entries_of_freeze_read_back_equal(sweep_case, tmp_path):
    """An entry stored as ``FrozenGraph.freeze(build_graph(...))`` under
    the Explorer's key text hits and equals the direct build; an entry
    the direct build stores equals the definition."""
    trace, reports, cands = sweep_case
    keys = {}
    for c in cands:
        keys.setdefault(explore_mod._graph_key(c.system, c.eligibility), c)
    old_root, new_root = tmp_path / "old", tmp_path / "new"
    writer = explorer(sweep_case, cache_dir=str(old_root))
    disk = DiskCache(str(old_root))
    fn = writer.smp_seconds_fn
    refs = {}
    for key, c in keys.items():
        refs[key] = FrozenGraph.freeze(build_graph(
            trace, c.system, reports, c.eligibility, smp_cost="mean",
            smp_seconds_fn=fn))
        disk.put(writer._graph_disk_text(key), refs[key])

    reader = explorer(sweep_case, cache_dir=str(old_root))
    read = reader.explore(cands, top_k=3)
    assert reader.stats.disk_hits == reader.stats.graph_misses == len(keys)
    assert reader._analysis is None             # nothing was built
    direct = explorer(sweep_case, cache_dir=str(new_root))
    built = direct.explore(cands, top_k=3)
    assert direct.stats.disk_hits == 0 and direct._analysis is not None
    assert [(o.name, o.makespan_s) for o in read.ranked] == \
        [(o.name, o.makespan_s) for o in built.ranked]
    again = DiskCache(str(new_root))
    for key in keys:
        assert_same_graph(reader._graphs[key][0], refs[key])
        assert_same_graph(direct._graphs[key][0], refs[key])
        assert_same_graph(again.get(direct._graph_disk_text(key)), refs[key])
