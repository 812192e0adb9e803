"""Own-order lanes of the torch engine and the routing that sends lanes there.

A cohort with no order (``order=None``) steps each lane through its own
heap order on the lane axis: every step pops the lane's ``(ready_t,
creation index, rank)`` minimum on the device.  On the CPU
(``device="cpu"``) such lanes pop ``simulate_fast``'s dispatch order
(``order_out``) row for row, place every compute task where it does, and
give its makespans and busy sums within ``TORCH_RTOL``: on the blocked
matmul at n 256 with three accelerator kinds, on the Cholesky's Fig. 9
designs, and on drawn two-pool DAGs with ties, under both policies.  Own-
order and replayed cohorts share slices without changing each other's
results.  The replay protocol counts each lane once, counts own-order
lanes in ``own_order_lanes``, leaves the ``batch`` engine as the JAX
package's and, under pruning, routes as it did without the seam.  The
card's test is in ``test_torch_own_order_card.py``.
"""
import functools
import itertools

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

from repro.core import batchsim as ref_batchsim
from repro.core import devices as ref_devices
from repro.core import replay as ref_replay
from repro.testing import synth as ref_synth

from repro_torch.apps import cholesky as ch
from repro_torch.apps import matmul as mm
from repro_torch.core import batchsim, devices, fastsim, replay, taskgraph
from repro_torch.core import torchsim
from repro_torch.core.diskcache import DiskCache
from repro_torch.core.explore import Explorer, orders_disk_text
from repro_torch.core.graphcache import CompileCache
from repro_torch.core.hlsreport import a9_smp_seconds
from repro_torch.testing import synth

from own_order_common import MXM, cholesky_candidates, frozen, mxm_reports

RTOL = replay.TORCH_RTOL
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """A lane's tensors are small: one intra-op thread runs them as fast
    and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@functools.lru_cache(maxsize=None)
def matmul_families(n=256, most=2):
    """``(graph, systems)`` per set of kinds ±SMP of the matmul at ``n``,
    bs 64: every slot count 1..``most`` of each kind of the set."""
    trace = mm.trace_matmul(n, 64, verify=False)
    reports = mxm_reports()
    fams = []
    for m in range(1, len(MXM) + 1):
        for kinds in itertools.combinations(MXM, m):
            for smp in (True, False):
                elig = {"mxm_block": kinds + (("smp",) if smp else ())}
                fg = frozen(trace, reports, kinds, elig,
                            a9_smp_seconds("float32"))
                systems = [devices.zynq_system(
                    f"{'-'.join(map(str, c))}{'+smp' if smp else ''}",
                    dict(zip(kinds, c)))
                    for c in itertools.product(range(1, most + 1),
                                               repeat=m)]
                fams.append((fg, systems))
    return fams


@functools.lru_cache(maxsize=None)
def cholesky_families():
    """``(graph, systems)`` per Fig. 9 design, with the SMP (as in the
    paper) and FPGA only, at 1..3 times its slots, the Cholesky at n 256."""
    trace = ch.trace_cholesky(n=256, bs=64)
    reports = ch.report_map(bs=64)
    fams = []
    for base in ch.candidates(bs=64):
        accs = base.system.meta["accelerators"]
        for smp in (True, False):
            elig = {op: (kinds if smp else
                         tuple(d for d in kinds if d != "smp") or kinds)
                    for op, kinds in base.eligibility.kinds_by_kernel.items()}
            fg = frozen(trace, reports, tuple(accs), elig,
                        a9_smp_seconds("float64"))
            systems = [devices.zynq_system(
                f"{base.name}x{k}{'' if smp else '-fpga'}",
                {kind: n * k for kind, n in accs.items()})
                for k in range(1, 4)]
            fams.append((fg, systems))
    return fams


def layouts(fg, systems):
    return [fastsim.pool_layout(fg.kinds, s) for s in systems]


def stepped(fg, systems, policy):
    """Every system a lane of one own-order cohort, stepped one step at a
    time on the CPU; returns each lane's rows in the order they ran and
    its schedule-free result."""
    lays = layouts(fg, systems)
    kind_pool = lays[0][2]
    xs, pos_of, npred = torchsim._own_xs(fg, kind_pool)
    heap = np.argsort(pos_of)
    n, B = fg.n, len(systems)
    lanes = {k: np.repeat(v[:, None], B, axis=1) for k, v in xs.items()
             if k != "succ"}
    lanes["succ"] = np.repeat(xs["succ"][:, :, None], B, axis=2)
    lanes["valid"] = np.ones((n, B), dtype=bool)
    blocks = [torch.from_numpy(b) for b in torchsim._pack(lanes)]
    P = len(lays[0][0])
    S = max(max(lay[1]) for lay in lays)
    clocks = np.full((P, S, B), np.inf)
    for li, lay in enumerate(lays):
        for p, cnt in enumerate(lay[1]):
            clocks[p, :cnt, li] = 0.0
    np_lanes = np.ones((n + 1, B), dtype=np.int32)
    np_lanes[:n] = npred[:, None]
    st = torchsim._State(P, S, B, n + 1, CPU)
    st.reset(clocks, torch.from_numpy(np_lanes), torch.ones(B, dtype=bool))
    kinds = fg.kinds
    kp = torch.from_numpy(np.tile(np.asarray(kind_pool), (B, 1)))
    sk = torch.full((B,), kinds.index("smp") if "smp" in kinds else -1)
    K = xs["own_opts"].shape[1]
    ran = [[] for _ in range(B)]
    for _ in range(n):
        before = st.npred[:n].clone()
        torchsim._steps(*blocks, st, kp, sk, policy == "eft", K, 1)
        pos, lane = torch.nonzero((st.npred[:n] == 1) & (before != 1),
                                  as_tuple=True)
        assert sorted(lane.tolist()) == list(range(B))
        for p, b in zip(pos.tolist(), lane.tolist()):
            ran[b].append(int(heap[p]))
    div, mk, busy, seen, place = st.outputs()
    assert not div.any()
    done = replay.lane_results(fg, lays[0][0], [lay[1] for lay in lays],
                               range(B), policy, mk, busy, seen,
                               place[pos_of].astype(np.int64))
    return ran, [done[b] for b in range(B)]


def assert_own_is_fast(fg, systems, policy):
    ran, sims = stepped(fg, systems, policy)
    for s, order, sim in zip(systems, ran, sims):
        want_order = []
        want = fastsim.simulate_fast(fg, s, policy, order_out=want_order)
        assert order == want_order, s.name
        assert replay.sims_equivalent(sim, want, RTOL), s.name


@pytest.mark.parametrize("policy", ["availability", "eft"])
def test_own_order_pops_simulate_fasts_order_on_the_matmul(policy):
    """The designs of all three kinds and of ``mxm64`` alone, ±SMP (the
    megabatch test below runs every family)."""
    fams = matmul_families()
    for fg, systems in fams[:2] + fams[-2:]:
        assert_own_is_fast(fg, systems, policy)


@pytest.mark.parametrize("policy", ["availability", "eft"])
def test_own_order_pops_simulate_fasts_order_on_the_cholesky(policy):
    for fg, systems in cholesky_families():
        assert_own_is_fast(fg, systems, policy)


@st.composite
def two_pool_dags(draw):
    """A DAG of ``n`` compute tasks on kinds ``a``/``b`` (either or both,
    in either preference order) with costs drawn from a few values,
    zero included, so that ready times tie often; edges from earlier to
    later tasks, creation indices drawn with repeats."""
    n = draw(st.integers(2, 24))
    costs = st.sampled_from([0.0, 0.25, 0.5, 1.0])
    g = taskgraph.TaskGraph()
    uids = []
    for i in range(n):
        kinds = draw(st.sampled_from([("a",), ("b",), ("a", "b"),
                                      ("b", "a")]))
        t = taskgraph.Task(uid=g.new_uid(), name=f"t{i}", devices=kinds,
                           costs={k: draw(costs) for k in kinds},
                           creation_index=draw(st.integers(0, n // 2)),
                           meta={"role": "compute"})
        g.add_task(t, infer_deps=False)
        for j in range(i):
            if draw(st.integers(0, 3)) == 0:
                g.add_edge(uids[j], t.uid)
        uids.append(t.uid)
    return fastsim.FrozenGraph.freeze(g)


@hypothesis.given(two_pool_dags(), st.integers(1, 3), st.integers(1, 3),
                  st.sampled_from(["availability", "eft"]))
@hypothesis.settings(deadline=None, max_examples=25)
def test_own_order_pops_simulate_fasts_order_on_drawn_dags(fg, ca, cb,
                                                           policy):
    systems = [devices.SystemConfig(
        name=f"s{i}-{j}", pools=[devices.DevicePool("pa", ("a",), i),
                                 devices.DevicePool("pb", ("b",), j)],
        shared=[devices.SharedResource("x", 1)])
        for i in range(1, ca + 1) for j in range(1, cb + 1)]
    assert_own_is_fast(fg, systems, policy)


def row_inputs(fg, r, kind_pool):
    """One row's step inputs by their definition, from the FrozenGraph's
    plain-list mirror: ``(r, tb, c, is_comp, k_first, own_opts, own_cost,
    par_opts, par_cost, act, bad_row, succ)``, options and successors
    unpadded, costs with NaN kept."""
    (_uids, ci, cond, first, opts, asets, costs, succs, _np, is_comp,
     rankmaps, *_) = fg._runtime()
    tb = ci[r] * fg.n + rankmaps[0][r]
    c = cond[r]
    if is_comp[r]:
        pools = [k for k in opts[r] if kind_pool[k] >= 0]
        bad = not pools or any(np.isnan(costs[r][k]) for k in pools)
    else:
        bad = kind_pool[first[r]] < 0 or np.isnan(costs[r][first[r]])
    act = [k in asets[r] and c >= 0 for k in range(len(fg.kinds))]
    return (r, tb, c, is_comp[r], first[r], list(opts[r]), costs[r],
            list(opts[c]) if c >= 0 else [],
            costs[c] if c >= 0 else [0.0] * len(fg.kinds), act, bad,
            list(succs[r]))


@pytest.mark.parametrize("which", ["matmul", "cholesky", "synth"])
def test_step_inputs_are_each_rows_definition(which):
    """The packed step inputs (``_group_xs``, built from per-row arrays)
    hold each row's definition in the order asked, under the cohort's
    pool map and under maps that leave kinds without a pool."""
    if which == "synth":
        cases = [synth.frozen_for(synth.synth_trace(n), smp)[0]
                 for n in (5, 17) for smp in (True, False)]
    else:
        fams = matmul_families() if which == "matmul" \
            else cholesky_families()
        cases = [fg for fg, _ in fams[::3]]
    for fg in cases:
        kp = fastsim.pool_layout(
            fg.kinds, devices.zynq_system("s", {k: 1 for k in fg.kinds
                                                if k.startswith("fpga:")}))[2]
        order = np.random.default_rng(fg.n).permutation(fg.n).tolist()
        for kind_pool in (kp, [-1] * len(kp)):
            xs = torchsim._group_xs(fg, order, kind_pool)
            for t, r in enumerate(order):
                (r_, tb, c, comp, first, opts, cost, popts, pcost, act, bad,
                 succ) = row_inputs(fg, r, kind_pool)
                assert (xs["r"][t], xs["tb"][t], xs["c"][t],
                        xs["is_comp"][t], xs["k_first"][t],
                        xs["bad_row"][t]) == (r_, tb, c, comp, first, bad)
                k, sc = len(opts), len(succ)
                assert list(xs["own_opts"][t, :k]) == opts
                assert (xs["own_opts"][t, k:] == -1).all()
                assert list(xs["par_opts"][t, :len(popts)]) == popts
                assert (xs["par_opts"][t, len(popts):] == -1).all()
                assert np.array_equal(xs["own_cost"][t], np.nan_to_num(cost))
                assert np.array_equal(xs["par_cost"][t],
                                      np.nan_to_num(pcost))
                assert list(xs["act"][t]) == act
                assert list(xs["succ"][t, :sc]) == succ
                assert (xs["succ"][t, sc:] == fg.n).all()


def scan(cohorts, policy="availability"):
    return torchsim._scan_cohorts(cohorts, policy, chunk=64, device=CPU,
                                  cache=CompileCache())


def plain(out):
    done, div, retired = out
    return ({p: (s.makespan, s.busy, s.placements, s.pool_slots)
             for p, s in done.items()}, div, retired)


def test_a_megabatch_of_own_order_lanes_is_simulate_fast():
    """Every family of the matmul as an own-order cohort of one call:
    nothing diverges, and each lane is within the tier of
    ``simulate_fast`` with its placements."""
    fams = matmul_families()
    outs = scan([(fg, None, layouts(fg, systems), None)
                 for fg, systems in fams])
    for (fg, systems), (done, div, retired) in zip(fams, outs):
        assert div == [] and retired == {} and len(done) == len(systems)
        for pos, s in enumerate(systems):
            want = fastsim.simulate_fast(fg, s, "availability")
            assert replay.sims_equivalent(done[pos], want, RTOL), s.name


def test_replayed_and_own_order_cohorts_share_slices_unchanged():
    """A megabatch mixing a replayed cohort (the Cholesky, its recorded
    order) and own-order ones (the matmul) gives each cohort what it gives
    alone, bit for bit."""
    cfg, csys = cholesky_families()[0]
    order = []
    fastsim.simulate_fast(cfg, csys[0], "availability", order_out=order)
    replayed = (cfg, tuple(order), layouts(cfg, csys), None)
    owns = [(fg, None, layouts(fg, systems), None)
            for fg, systems in matmul_families()[:3]]
    mixed = scan([replayed] + owns)
    alone = scan([replayed]) + scan(owns)
    assert [plain(o) for o in mixed] == [plain(o) for o in alone]
    assert mixed[0][0]


def totals(stats):
    return (stats.lockstep_lanes + stats.order_pinned_lanes
            + stats.reference_lanes + stats.serial_fallback_lanes
            + stats.small_group_lanes + stats.retired_lanes)


def test_megabatch_routing_counts_each_lane_once():
    """From an empty library each group of at least ``MIN_LOCKSTEP``
    lanes discovers one lane on the exact path and every other lane steps
    its own order; the next call discovers at most one lane a group, and
    the third none.  Each call counts every lane once and stays within
    the tier of ``simulate_fast``."""
    fams = [(fg, systems) for fg, systems in matmul_families(most=3)]
    lib = replay.ReplayLibrary()
    wide = sum(1 for _, systems in fams
               if len(systems) >= replay.MIN_LOCKSTEP)
    for call in range(3):
        stats = replay.BatchStats()
        got = torchsim.simulate_torch_many(fams, device="cpu", stats=stats,
                                           library=lib)
        lanes = sum(len(systems) for _, systems in fams)
        assert totals(stats) == lanes
        assert stats.order_pinned_lanes == stats.small_group_lanes == 0
        assert stats.serial_fallback_lanes == 0
        assert stats.own_order_lanes <= stats.lockstep_lanes
        if call == 0:
            assert stats.reference_lanes == wide
            assert stats.own_order_lanes == stats.lockstep_lanes
        elif call == 1:
            assert stats.reference_lanes <= wide
        else:
            assert stats.reference_lanes == 0 and stats.diverged_lanes == 0
        for (fg, systems), sims in zip(fams, got):
            for s, sim in zip(systems, sims):
                want = fastsim.simulate_fast(fg, s, "availability")
                assert sim.placements == want.placements, s.name
                assert replay.makespans_close(sim.makespan, want.makespan,
                                              RTOL), s.name


def test_per_graph_routing_sends_small_groups_own_order():
    """One graph through ``simulate_torch``: a group under
    ``MIN_LOCKSTEP`` steps its own order through the seam, counted as
    lockstep and own-order lanes."""
    fg, systems = matmul_families()[0]         # one kind: 2 systems
    assert len(systems) < replay.MIN_LOCKSTEP
    stats = replay.BatchStats()
    got = torchsim.simulate_torch(fg, systems, device="cpu", stats=stats)
    assert stats.own_order_lanes == stats.lockstep_lanes == len(systems)
    assert totals(stats) == len(systems)
    for s, sim in zip(systems, got):
        want = fastsim.simulate_fast(fg, s, "availability")
        assert sim.system == s.name
        assert replay.sims_equivalent(sim, want, RTOL)


@pytest.mark.parametrize("calls", [1, 3])
def test_the_batch_engine_is_the_jax_packages(calls):
    """``batch`` keeps the protocol without the seam: over repeat calls
    on one library its results equal the JAX package's bit for bit and
    its counters too, with no own-order lane."""
    fg_ref, _ = ref_synth.frozen_for(ref_synth.synth_trace(30), True)
    fg, _ = synth.frozen_for(synth.synth_trace(30), True)
    counts = [1, 1, 2, 3, 4, 6, 8, 12]
    mk = lambda mod: [mod.zynq_system(f"{n}acc{i}",  # noqa: E731
                                      {"fpga:k": n})
                      for i, n in enumerate(counts)]
    ref_lib, lib = ref_replay.ReplayLibrary(), replay.ReplayLibrary()
    for _ in range(calls):
        ref_stats, stats = ref_replay.BatchStats(), replay.BatchStats()
        want = ref_batchsim.simulate_batch(fg_ref, mk(ref_devices),
                                           "availability", min_lockstep=2,
                                           stats=ref_stats, library=ref_lib)
        got = batchsim.simulate_batch(fg, mk(devices), "availability",
                                      min_lockstep=2, stats=stats,
                                      library=lib)
        for g, w in zip(got, want):
            assert (g.makespan, g.busy, g.placements, g.pool_slots) == \
                (w.makespan, w.busy, w.placements, w.pool_slots)
        mine = stats.as_dict()
        assert mine.pop("own_order_lanes") == 0
        assert mine == ref_stats.as_dict()


def test_own_marks_are_neither_pins_nor_exported():
    """``mark_own`` remembers a signature for the seam alone: no pin, no
    dirty flag, nothing in the export, and gone with its graph."""
    fg, systems = matmul_families()[3]
    lay = layouts(fg, systems)[0]
    order = []
    fastsim.simulate_fast(fg, systems[0], "availability", order_out=order)
    lib = replay.ReplayLibrary()
    key = lib.key(fg, lay, "availability")
    lib.record(key, order, tuple(lay[1]))
    lib.take_dirty("availability")
    before = lib.lookup(key), lib.export(fg.content_hash(), "availability")
    sig = (7,) * len(lay[1])
    lib.mark_own(key, sig)
    assert lib.own_sigs(key) == {sig}
    assert (lib.lookup(key),
            lib.export(fg.content_hash(), "availability")) == before
    assert lib.take_dirty("availability") == []
    lib.drop_graph(fg.content_hash())
    assert lib.own_sigs(key) == set()


def test_seam_marks_stay_out_of_the_batch_engines_routing(tmp_path):
    """Lanes that diverge from a library order and step their own orders
    are marked for the seam alone.  The second of three torch sweeps on
    one library marks such lanes and writes its orders to a disk cache;
    the third sends the marked lanes to their own orders at once.  The
    disk cache carries no pin, and a ``batch`` Explorer on it routes and
    ranks as one given only its orders and signature maps."""
    trace, reports = ch.trace_cholesky(n=512, bs=64), ch.report_map(bs=64)
    cands = [c for _, c in cholesky_candidates()]
    smp = a9_smp_seconds("float64")
    store = str(tmp_path / "store")
    lib = replay.ReplayLibrary()
    for call in range(3):
        ex = Explorer(trace, reports, engine="torch", device="cpu",
                      smp_seconds_fn=smp, order_library=lib,
                      cache_dir=store if call == 1 else None)
        ex.explore(cands, top_k=3)
        stats = ex.batch_stats
        if call == 1:       # diverged lanes beyond one discovery a group
            assert stats.diverged_lanes > stats.reference_lanes
        if call == 2:
            assert stats.diverged_lanes == stats.reference_lanes == 0
            assert stats.own_order_lanes > 0
    disk = DiskCache(store)
    written = {}
    for gh in {key[0] for key in lib._entries}:
        got = disk.get(orders_disk_text(gh, "availability"))
        if got is not None:
            written[gh] = got
    assert written
    plain = replay.ReplayLibrary()
    for gh, payload in written.items():
        assert all(not e["pins"] for e in payload.values())
        plain.stage(gh, "availability", {
            t: {"orders": e["orders"], "sigs": e["sigs"]}
            for t, e in payload.items()})

    def batch(**kw):
        ex = Explorer(trace, reports, engine="batch", smp_seconds_fn=smp,
                      **kw)
        res = ex.explore(cands, top_k=3)
        return ex.batch_stats.as_dict(), [(o.name, o.makespan_s)
                                          for o in res.ranked]

    assert batch(cache_dir=store) == batch(order_library=plain)


def test_pruned_sweeps_route_as_without_the_seam():
    """Under pruning the torch engine's megabatch routes as the protocol
    without the own-order seam: the same results and counters, no
    own-order lane."""
    fams = matmul_families()[4:8]
    spans = sorted(fastsim.simulate_fast(fg, s, "availability").makespan
                   for fg, systems in fams for s in systems)
    cut = spans[2]

    def prunes():
        inc = replay.Incumbent(3, seed=cut)
        return [replay.PruneContext(inc, None, RTOL) for _ in fams]

    def lockstep_many(cohorts):
        return torchsim._scan_cohorts(
            cohorts, "availability", chunk=torchsim.MEGABATCH_CHUNK,
            device=CPU, cache=CompileCache())

    s_seam, s_plain = replay.BatchStats(), replay.BatchStats()
    got = torchsim.simulate_torch_many(fams, device="cpu", stats=s_seam,
                                       prunes=prunes(), min_lockstep=2)
    want = replay.simulate_many(fams, "availability",
                                lockstep_many_fn=lockstep_many,
                                stats=s_plain, prunes=prunes(),
                                min_lockstep=2)
    assert s_seam.as_dict() == s_plain.as_dict()
    assert s_seam.own_order_lanes == 0 and s_seam.retired_lanes > 0

    def view(r):
        if isinstance(r, replay.Retired):
            return ("retired", r.bound)
        return (r.makespan, r.busy, r.placements)

    assert [[view(r) for r in f] for f in got] == \
        [[view(r) for r in f] for f in want]
