"""The port's torch engine against the JAX package's engines.

``repro_torch.core.torchsim`` is pinned at the relaxed tier: makespans and
busy sums within ``1e-6`` relative of the reference (``sims_equivalent``
at 1e-6 — the same tier as ``JAX_RTOL``; the state is f64 end to end, so
the residual is float reordering only), placements and pool layouts
exact.  Every population is built with the JAX package and the port from
the same seeded inputs, and the port's results are held to the JAX
package's ``simulate_fast`` and ``simulate_jax_many``
(``step_impl="lax"``), which runs the same replay protocol as the port's
megabatch.  The torch engine runs on the CPU here (``device="cpu"``); the
card runs the ``gpu`` tests.
"""
import collections
import pickle
import sys
import threading
import time

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

from repro.core import devices as ref_devices
from repro.core import fastsim as ref_fastsim
from repro.core import replay as ref_replay
from repro.core import taskgraph as ref_taskgraph
from repro.core import trace as ref_trace
from repro.testing import synth as ref_synth

from repro_torch import DeviceError
from repro_torch.core import devices, fastsim, replay, taskgraph, trace
from repro_torch.core import torchsim
from repro_torch.kernels import lockstep_step
from repro_torch.testing import synth

#: Same tier as ``JAX_RTOL``; f64 end to end.
RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """The step loop's tensors are small: one intra-op thread runs them
    about as fast and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jaxsim(monkeypatch):
    """``repro.core.jaxsim``, runnable on the installed JAX.

    The reference engine enters float64 through
    ``jax.experimental.enable_x64``, which newer JAX releases provide as
    ``jax.enable_x64``; for the test's duration the old name is supplied
    and jaxsim's cached import failure is cleared (both restored after)."""
    import jax
    import jax.experimental
    from repro.core import jaxsim as mod
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda new_val=True: jax.enable_x64(new_val),
                            raising=False)
        monkeypatch.setattr(mod, "_JAX_MODULES", None)
        monkeypatch.setattr(mod, "_JAX_ERROR", None)
    assert mod.have_jax()
    return mod


def both_frozen(n, smp, n_regions=4):
    """The same synthetic trace frozen by the JAX package and the port."""
    fg_ref, _ = ref_synth.frozen_for(ref_synth.synth_trace(n, n_regions), smp)
    fg, _ = synth.frozen_for(synth.synth_trace(n, n_regions), smp)
    assert fg.content_hash() == fg_ref.content_hash()
    return fg_ref, fg


def zynq_pair(counts):
    names = [f"{n}acc{i}" for i, n in enumerate(counts)]
    return ([ref_devices.zynq_system(m, {"fpga:k": n})
             for m, n in zip(names, counts)],
            [devices.zynq_system(m, {"fpga:k": n})
             for m, n in zip(names, counts)])


def assert_tier(got, ref, ref_systems):
    """Port results within the tier of the reference's, lane by lane,
    placements exact, and the makespan rankings equivalent."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.placements == r.placements
        assert g.pool_slots == r.pool_slots
        assert g.policy == r.policy and set(g.busy) == set(r.busy)
        assert replay.makespans_close(g.makespan, r.makespan, RTOL), \
            (g.makespan, r.makespan)
        for p in r.busy:
            assert replay.makespans_close(g.busy[p], r.busy[p], RTOL)
    order = lambda sims: [ref_systems[i].name for _, i in sorted(  # noqa: E731
        (s.makespan, i) for i, s in enumerate(sims))]
    spans = {s.name: r.makespan for s, r in zip(ref_systems, ref)}
    assert replay.rankings_equivalent(order(got), order(ref), spans, RTOL)


def fast_refs(fg_ref, ref_systems, policy):
    return [ref_fastsim.simulate_fast(fg_ref, s, policy) for s in ref_systems]


# ---------------------------------------------------------------------------
# randomized populations: policies × conditional DMA × heterogeneous slots
# ---------------------------------------------------------------------------


@st.composite
def random_trace_spec(draw):
    n = draw(st.integers(4, 16))
    n_regions = draw(st.integers(1, 4))
    costs = [draw(st.floats(1e-4, 5e-3)) for _ in range(n)]
    return n, n_regions, costs


def build_trace(mod, n, n_regions, costs):
    events = [mod.TraceEvent(index=i, name="k", created_at=i * 1e-6,
                             elapsed_smp=costs[i],
                             accesses=[((i % n_regions,), "inout", 512)],
                             devices=("fpga", "smp"))
              for i in range(n)]
    return mod.Trace(events=events, wall_seconds=1.0)


@hypothesis.given(random_trace_spec(), st.booleans(),
                  st.sampled_from(["availability", "eft"]),
                  st.lists(st.integers(1, 12), min_size=2, max_size=8))
@hypothesis.settings(deadline=None, max_examples=6)
def test_torch_tier_on_augmented_graphs(spec, smp, policy, slot_counts):
    """±smp exercises the conditional per-lane masking both ways; random
    slot lists mix saturated lanes (lockstep) with contended ones (the
    divergence fallback)."""
    fg_ref, _ = ref_synth.frozen_for(build_trace(ref_trace, *spec), smp)
    fg, _ = synth.frozen_for(build_trace(trace, *spec), smp)
    assert fg.content_hash() == fg_ref.content_hash()
    ref_systems, systems = zynq_pair(slot_counts)
    got = torchsim.simulate_torch(fg, systems, policy, device="cpu",
                                  min_lockstep=2)
    assert_tier(got, fast_refs(fg_ref, ref_systems, policy), ref_systems)


def two_pool_dag(mod_tg, mod_fs, n):
    g = mod_tg.TaskGraph()
    uids = []
    for i in range(n):
        kinds = ("a", "b") if i % 3 else ("b", "a")
        t = mod_tg.Task(uid=g.new_uid(), name=f"t{i}", devices=kinds,
                        costs={"a": 0.5 + (i % 5) * 0.25,
                               "b": 1.0 + (i % 3) * 0.5},
                        creation_index=i, meta={"role": "compute"})
        g.add_task(t, infer_deps=False)
        uids.append(t.uid)
        if i >= 1 and i % 2:
            g.add_edge(uids[i - 1], t.uid)
    return mod_fs.FrozenGraph.freeze(g)


def two_pool_systems(mod, ca, cb):
    return [mod.SystemConfig(name=f"s{i}-{j}",
                             pools=[mod.DevicePool("pa", ("a",), i),
                                    mod.DevicePool("pb", ("b",), j)],
                             shared=[mod.SharedResource("x", 1)])
            for i in range(1, ca + 1) for j in range(1, cb + 1)]


@hypothesis.given(st.integers(2, 20), st.integers(1, 3), st.integers(1, 3),
                  st.sampled_from(["availability", "eft"]))
@hypothesis.settings(deadline=None, max_examples=6)
def test_torch_tier_on_bare_dags_with_two_pools(n, ca, cb, policy):
    """Two device kinds, counts varying on both pools — heterogeneous slot
    counts beyond the single-accelerator shape."""
    fg_ref = two_pool_dag(ref_taskgraph, ref_fastsim, n)
    fg = two_pool_dag(taskgraph, fastsim, n)
    ref_systems = two_pool_systems(ref_devices, ca, cb)
    systems = two_pool_systems(devices, ca, cb)
    got = torchsim.simulate_torch(fg, systems, policy, device="cpu",
                                  min_lockstep=2)
    assert_tier(got, fast_refs(fg_ref, ref_systems, policy), ref_systems)


# ---------------------------------------------------------------------------
# against the JAX engine itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["availability", "eft"])
@pytest.mark.parametrize("smp", [False, True])
def test_torch_matches_jax_lax_engine(jaxsim, policy, smp):
    fg_ref, fg = both_frozen(20, smp)
    ref_systems, systems = zynq_pair(range(1, 9))
    stats_ref, stats = ref_replay.BatchStats(), replay.BatchStats()
    want = jaxsim.simulate_jax_many([(fg_ref, ref_systems)], policy,
                                    min_lockstep=2, step_impl="lax",
                                    stats=stats_ref)[0]
    got = torchsim.simulate_torch(fg, systems, policy, device="cpu",
                                  min_lockstep=2, stats=stats)
    assert_tier(got, want, ref_systems)
    assert_tier(got, fast_refs(fg_ref, ref_systems, policy), ref_systems)
    # the same replay protocol routed the same groups the same way, but
    # that after a cold group's one discovery the torch engine steps the
    # rest in their own orders, where the JAX megabatch replays the fresh
    # order and finishes each lane that diverged from it on the exact path
    exact = ("reference_lanes", "order_pinned_lanes",
             "serial_fallback_lanes", "small_group_lanes")
    moved = exact + ("lockstep_lanes", "own_order_lanes", "diverged_lanes")
    got_d, want_d = stats.as_dict(), stats_ref.as_dict()
    assert {k: v for k, v in got_d.items() if k not in moved} == \
        {k: v for k, v in want_d.items() if k not in moved}
    assert got_d["reference_lanes"] == got_d["groups"] >= 1
    assert all(got_d[k] == 0 for k in exact[1:])
    assert got_d["diverged_lanes"] == 0
    assert got_d["own_order_lanes"] == got_d["lockstep_lanes"] == \
        len(systems) - got_d["reference_lanes"]
    assert sum(want_d[k] for k in exact) == \
        got_d["reference_lanes"] + want_d["diverged_lanes"]
    assert want_d["lockstep_lanes"] + sum(want_d[k] for k in exact) == \
        len(systems)
    assert stats.lockstep_lanes > 0


def test_torch_many_matches_jax_many(jaxsim):
    """The megabatch: heterogeneous graphs (±SMP, two sizes) share one
    lane axis; per family the results match the JAX megabatch's and
    ``simulate_fast``'s."""
    pairs = [both_frozen(16, False), both_frozen(16, True),
             both_frozen(24, True, n_regions=3)]
    ref_systems, systems = zynq_pair(range(1, 9))
    want = jaxsim.simulate_jax_many([(r, ref_systems) for r, _ in pairs],
                                    "availability", min_lockstep=2,
                                    step_impl="lax")
    stats = replay.BatchStats()
    got = torchsim.simulate_torch_many([(p, systems) for _, p in pairs],
                                       "availability", device="cpu",
                                       min_lockstep=2, stats=stats)
    assert stats.lockstep_lanes > 0
    for (fg_ref, fg), g, w in zip(pairs, got, want):
        assert_tier(g, w, ref_systems)
        assert_tier(g, fast_refs(fg_ref, ref_systems, "availability"),
                    ref_systems)


def test_torch_pruned_top_k_matches_jax(jaxsim):
    """Post-scan retirement: with a live incumbent both engines retire
    the same lanes, and every kept lane stays inside the tier."""
    fg_ref, fg = both_frozen(24, True)
    counts = [1, 1, 2, 2, 3, 4, 6, 8, 12, 16]
    ref_systems, systems = zynq_pair(counts)
    spans = [s.makespan for s in fast_refs(fg_ref, ref_systems,
                                           "availability")]
    cut = sorted(spans)[2]

    def prune(mod):
        return mod.PruneContext(mod.Incumbent(3, seed=cut), None, RTOL)

    want = jaxsim.simulate_jax_many([(fg_ref, ref_systems)], "availability",
                                    min_lockstep=2, step_impl="lax",
                                    prunes=[prune(ref_replay)])[0]
    got = torchsim.simulate_torch(fg, systems, "availability", device="cpu",
                                  min_lockstep=2, prune=prune(replay))
    got_retired = [isinstance(g, replay.Retired) for g in got]
    assert got_retired == [isinstance(w, ref_replay.Retired) for w in want]
    assert any(got_retired) and not all(got_retired)
    kept = [(g, w, s) for g, w, s in zip(got, want, ref_systems)
            if not isinstance(g, replay.Retired)]
    for g, w, _ in kept:
        assert replay.makespans_close(g.makespan, w.makespan, RTOL)
        assert g.placements == w.placements


# ---------------------------------------------------------------------------
# protocol behaviour
# ---------------------------------------------------------------------------


def test_torch_divergent_lanes_fall_back_exactly():
    """A wide slot ramp forces event-order divergence: on a library that
    holds one lane's order (a cold call's discovery), the other lanes
    replay it and diverge; diverged lanes step their own heap orders in
    the loop, within the tier, and every lane is counted once."""
    fg_ref, fg = both_frozen(40, True)
    ref_systems, systems = zynq_pair(range(1, 25))
    lib = replay.ReplayLibrary()
    torchsim.simulate_torch(fg, systems, "availability", device="cpu",
                            min_lockstep=2, library=lib)
    stats = replay.BatchStats()
    got = torchsim.simulate_torch(fg, systems, "availability",
                                  device="cpu", min_lockstep=2, stats=stats,
                                  library=lib)
    refs = fast_refs(fg_ref, ref_systems, "availability")
    assert_tier(got, refs, ref_systems)
    assert stats.diverged_lanes > 0 and stats.lockstep_lanes > 0
    assert stats.own_order_lanes > 0
    assert (stats.lockstep_lanes + stats.order_pinned_lanes
            + stats.reference_lanes + stats.serial_fallback_lanes
            + stats.small_group_lanes) == len(systems)


def test_torch_chunking_is_invariant():
    """Chunk width is a performance knob, never a semantics knob."""
    _, fg = both_frozen(20, False)
    _, systems = zynq_pair(range(1, 13))
    base = torchsim.simulate_torch(fg, systems, device="cpu",
                                   min_lockstep=2)
    for chunk in (2, 3, 8, 64):
        got = torchsim.simulate_torch(fg, systems, device="cpu",
                                      min_lockstep=2, chunk=chunk)
        assert [s.makespan for s in got] == [s.makespan for s in base]
        assert [s.placements for s in got] == [s.placements for s in base]


def test_torch_pure_smp_lanes_skip_inactive_dma_rows():
    """Every compute task on the SMP: every DMA row is conditionally
    inactive, which is runtime state, never an eager check."""
    fg_ref, fg = both_frozen(24, True)
    mk = lambda mod: [mod.SystemConfig(  # noqa: E731
        name=f"smp{i}", pools=[mod.DevicePool("smp", ("smp",), i)],
        shared=[mod.SharedResource("submit", 1)]) for i in range(1, 9)]
    got = torchsim.simulate_torch(fg, mk(devices), device="cpu",
                                  min_lockstep=2)
    ref_systems = mk(ref_devices)
    assert_tier(got, fast_refs(fg_ref, ref_systems, "availability"),
                ref_systems)


def test_torch_raises_reference_error_on_live_bad_dispatch():
    g = taskgraph.TaskGraph()
    for i in range(10):
        kinds = ("a",) if i != 5 else ("gpu",)
        g.add_task(taskgraph.Task(uid=g.new_uid(), name=f"t{i}",
                                  devices=kinds, costs={kinds[0]: 1.0},
                                  creation_index=i,
                                  meta={"role": "compute"}),
                   infer_deps=False)
    fg = fastsim.FrozenGraph.freeze(g)
    systems = [devices.SystemConfig(
        name=f"s{i}", pools=[devices.DevicePool("pa", ("a",), i)],
        shared=[devices.SharedResource("x", 1)]) for i in range(1, 9)]
    with pytest.raises(RuntimeError, match="no compatible pool"):
        torchsim.simulate_torch(fg, systems, device="cpu", min_lockstep=2)


def test_scan_inputs_memoised_and_dropped_on_pickling(monkeypatch):
    # inputs are staged where the process-wide device cache lacks them
    monkeypatch.setattr(torchsim, "_DEV_XS_CACHE", collections.OrderedDict())
    _, fg = both_frozen(12, False)
    _, systems = zynq_pair(range(1, 9))
    first = torchsim.simulate_torch(fg, systems, device="cpu",
                                    min_lockstep=2)
    xs_id = id(next(iter(fg._torch_xs.values())))
    again = torchsim.simulate_torch(fg, systems, device="cpu",
                                    min_lockstep=2)
    assert id(next(iter(fg._torch_xs.values()))) == xs_id
    assert [s.makespan for s in again] == [s.makespan for s in first]
    clone = pickle.loads(pickle.dumps(fg))
    assert not hasattr(clone, "_torch_xs")
    assert not hasattr(clone, "_torch_caps")
    assert hasattr(fg, "_torch_rows") and not hasattr(clone, "_torch_rows")


@pytest.mark.parametrize("n,cap,want", [
    (1, 64, 8), (9, 64, 16), (64, 64, 64), (65, 64, 64), (5, 48, 8),
    (40, 48, 32), (3, 2, 2), (1, 1, 1)])
def test_bucket_is_a_power_of_two_within_the_cap(n, cap, want):
    assert torchsim._bucket(n, cap) == want


def test_bad_arguments_fail_fast():
    _, fg = both_frozen(8, False)
    _, systems = zynq_pair(range(1, 9))
    for bad in (0, -4):
        with pytest.raises(ValueError, match="chunk"):
            torchsim.simulate_torch(fg, systems, device="cpu", chunk=bad)
        with pytest.raises(ValueError, match="chunk"):
            torchsim.simulate_torch_many([(fg, systems)], device="cpu",
                                         chunk=bad)
    with pytest.raises(ValueError, match="policy"):
        torchsim.simulate_torch(fg, systems, "heft", device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        torchsim.simulate_torch(fg, systems, device="meta")


def test_cuda_without_a_card_raises_device_error():
    """The default device is the card; without one the engine raises and
    never runs on the host instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, fg = both_frozen(8, False)
    _, systems = zynq_pair(range(1, 9))
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(DeviceError):
            torchsim.simulate_torch(fg, systems, device=device)
        with pytest.raises(DeviceError):
            torchsim.simulate_torch_many([(fg, systems)], device=device)


@pytest.mark.gpu
def test_torch_on_the_card_matches_fast_and_launches_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import lockstep_step
    fg_ref, fg = both_frozen(24, True)
    ref_systems, systems = zynq_pair(range(1, 17))
    lockstep_step.LAUNCHES = 0
    got = torchsim.simulate_torch_many([(fg, systems)], device="cuda",
                                       min_lockstep=2)[0]
    assert lockstep_step.LAUNCHES > 0
    assert_tier(got, fast_refs(fg_ref, ref_systems, "availability"),
                ref_systems)
    assert np.isfinite([s.makespan for s in got]).all()


class YieldingCache(collections.OrderedDict):
    """A cache that gives up the interpreter lock around every access
    (a 1 ms ``time.sleep``), so another thread runs between any two steps of
    a lookup, an eviction or a refresh that no lock holds together."""

    def _yield(self):
        time.sleep(0.001)

    def __len__(self):
        self._yield()
        return super().__len__()

    def __iter__(self):
        self._yield()
        return super().__iter__()

    def get(self, key, default=None):
        self._yield()
        got = super().get(key, default)
        self._yield()
        return got

    def __setitem__(self, key, value):
        self._yield()
        super().__setitem__(key, value)

    def pop(self, key, *default):
        self._yield()
        return super().pop(key, *default)

    def popitem(self, last=True):
        self._yield()
        return super().popitem(last)

    def move_to_end(self, key, last=True):
        self._yield()
        super().move_to_end(key, last)


@pytest.mark.parametrize("share", [False, True],
                         ids=["own_graphs", "shared_graphs"])
def test_threads_sharing_the_engine_caches_get_their_serial_results(
        monkeypatch, share):
    """Eight threads sweep through ``simulate_torch_many`` at once, as the
    sweep service's request threads do, with every cache at one entry so
    each insert evicts another thread's: the device-block cache
    (``_DEV_XS_CACHE``) and, with ``shared_graphs`` (two threads on each
    FrozenGraph, on different slot ramps), the per-graph memos.  The
    caches yield the interpreter lock at every access
    (:class:`YieldingCache`).  No thread raises, and every result equals
    its serial run's."""
    monkeypatch.setattr(torchsim, "_DEV_XS_CACHE_CAP", 1)
    monkeypatch.setattr(torchsim, "_XS_CACHE_CAP", 1)
    monkeypatch.setattr(torchsim, "_DEV_XS_CACHE", YieldingCache())
    sizes = [12, 12, 14, 14, 16, 16, 18, 18] if share \
        else [12, 13, 14, 15, 16, 17, 18, 19]
    graphs = {n: synth.frozen_for(synth.synth_trace(n), n % 2 == 0)[0]
              for n in sorted(set(sizes))}
    jobs = [(graphs[n], zynq_pair(range(1 + i % 2, 9 + i % 2))[1])
            for i, n in enumerate(sizes)]

    def sweep(fg, systems):
        res = torchsim.simulate_torch_many([(fg, systems)], device="cpu",
                                           min_lockstep=2)[0]
        return [(s.makespan, s.placements) for s in res]

    serial = [sweep(fg, systems) for fg, systems in jobs]
    for fg in graphs.values():
        fg._torch_xs, fg._torch_caps = YieldingCache(), YieldingCache()
    got = [[] for _ in jobs]
    errors = []
    start = threading.Barrier(len(jobs))

    def worker(i):
        try:
            start.wait(timeout=30)
            for _ in range(2):
                got[i].append(sweep(*jobs[i]))
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(f"thread {i}: {exc!r}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, runs in enumerate(got):
        assert runs == [serial[i]] * 2, i


# ---------------------------------------------------------------------------
# the U-step body and the compile cache
# ---------------------------------------------------------------------------


def legacy_run(xs, clocks, ready, placement, busy, seen, kind_pool, smp_kid,
               eft):
    """The step loop as it stood before the compile cache: the whole scan
    over ``T`` steps, one dict entry per step input.

    Step inputs ``xs`` are lane-aligned (``[T, B, ...]`` — each lane's
    cohort rows pre-gathered on the host by :func:`_scan_cohorts`) and
    per-step ``valid`` masks make the task-axis padding inert.  ``clocks``,
    ``ready``, ``placement``, ``busy`` and ``seen`` are updated in place.
    Returns ``(makespan, busy, seen, placement, div)``."""
    B = clocks.shape[2]
    dev = clocks.device
    f64 = clocks.dtype
    K = xs["own_opts"].shape[2]

    def choose(opts, cost, rt, minc):
        """Vectorised reference `_choose_kind` over all lanes: options
        visited in annotation order, strict < on (key, pref) — the
        lowest-index winner, identical tie-breaks to the exact engines.
        ``minc [P, B]`` is the step's hoisted earliest-free-slot
        reduction."""
        best_k = torch.full((B,), -1, dtype=torch.int64, device=dev)
        bv = torch.zeros((B,), dtype=f64, device=dev)
        bp = torch.zeros((B,), dtype=f64, device=dev)
        for j in range(K):                      # K is tiny
            k = opts[:, j]
            kk = k.clamp(min=0)
            pi = torchsim._gather_lane(kind_pool, kk)
            valid = (k >= 0) & (pi >= 0)
            start = torch.maximum(rt, torchsim._gather_row(minc, pi.clamp(min=0)))
            keyv = start + torchsim._gather_lane(cost, kk) if eft else start
            pref = (k == smp_kid).to(f64)
            better = valid & ((best_k < 0) | (keyv < bv)
                              | ((keyv == bv) & (pref < bp)))
            bv = torch.where(better, keyv, bv)
            bp = torch.where(better, pref, bp)
            best_k = torch.where(better, k, best_k)
        return best_k

    makespan = torch.zeros((B,), dtype=f64, device=dev)
    prev_rt = torch.full((B,), -torch.inf, dtype=f64, device=dev)
    prev_tb = torch.full((B,), -1, dtype=torch.int64, device=dev)
    div = torch.zeros((B,), dtype=torch.bool, device=dev)
    names = tuple(xs)
    for step_x in zip(*(xs[k] for k in names)):
        x = dict(zip(names, step_x))
        valid = x["valid"]                                  # [B]
        r = x["r"]                       # dummy row n_max on invalid steps
        rt = torchsim._gather_row(ready, r)                          # [B]
        tbv = x["tb"]
        # heap-key monotonicity: a lane whose popped (ready_t, tb) key
        # ever fails to strictly increase is not executing its own heap
        # order — flag it for the exact fallback (and any lane that live-
        # executes a bad row, below)
        div |= valid & ((rt < prev_rt) | ((rt == prev_rt) & (tbv <= prev_tb)))

        # earliest-free slot per (pool, lane), shared by both choose passes
        minc = torch.amin(clocks, dim=1)                    # [P, B]

        # ---- conditional pass-through (per-lane mask) -------------------
        c = x["c"]
        has_cond = (c >= 0) & valid
        cmax = c.clamp(min=0)
        pk_old = torchsim._gather_row(placement, cmax).long()        # [B]
        chosen_p = choose(x["par_opts"], x["par_cost"], rt, minc)
        pk = torch.where(pk_old < 0, chosen_p, pk_old)
        torchsim._set_row(placement, cmax,
                 torch.where(has_cond, pk, pk_old).to(placement.dtype))
        live = (~has_cond | torchsim._gather_lane(x["act"], pk.clamp(min=0))) & valid

        # ---- dispatch + commit for the lanes executing the row ----------
        k_own = torchsim._gather_row(placement, r).long()
        und = k_own < 0
        chosen_o = choose(x["own_opts"], x["own_cost"], rt, minc)
        is_comp = x["is_comp"]
        k = torch.where(is_comp, torch.where(und, chosen_o, k_own),
                        x["k_first"])
        torchsim._set_row(placement, r,
                 torch.where(is_comp & live & und, k, k_own
                             ).to(placement.dtype))
        div |= live & (x["bad_row"] | (k < 0))
        kk = k.clamp(min=0)
        p = torchsim._gather_lane(kind_pool, kk).clamp(min=0)        # [B]
        base = torchsim._gather_lane(x["own_cost"], kk)              # [B]
        end = lockstep_step.step_commit(clocks, busy, seen, p, rt, base, live)
        end_eff = torch.where(live, end, torch.where(valid, rt, 0.0))
        makespan = torch.maximum(makespan, end_eff)
        succ = x["succ"]                                    # [SC, B]
        ready.scatter_reduce_(0, succ, end_eff.unsqueeze(0).expand_as(succ),
                              reduce="amax", include_self=True)
        prev_rt = torch.where(valid, rt, prev_rt)
        prev_tb = torch.where(valid, tbv, prev_tb)
    return makespan, busy, seen, placement, div


def lane_inputs(fg, systems, T, policy):
    """One cohort's step inputs, lane-aligned over ``systems``, cut to
    its first ``T`` steps: the old layout (``[T, B, ...]``, successors
    ``[T, SC, B]``) with ``valid`` set, the initial clocks, each lane's
    pool map and SMP kind, and the dummy row ``fg.n``."""
    order = []
    fastsim.simulate_fast(fg, systems[0], policy, order_out=order)
    assert len(order) >= T
    layouts = [fastsim.pool_layout(fg.kinds, s) for s in systems]
    kind_pool = layouts[0][2]
    xs = torchsim._group_xs(fg, order, kind_pool)
    B = len(systems)
    lanes = {k: np.repeat(v[:T, None], B, axis=1) for k, v in xs.items()
             if k != "succ"}
    lanes["succ"] = np.repeat(xs["succ"][:T, :, None], B, axis=2)
    lanes["valid"] = np.ones((T, B), dtype=bool)
    S = max(max(lay[1]) for lay in layouts)
    clocks = np.full((len(layouts[0][0]), S, B), np.inf)
    for li, lay in enumerate(layouts):
        for p, cnt in enumerate(lay[1]):
            clocks[p, :cnt, li] = 0.0
    kinds = fg.kinds
    smp = kinds.index("smp") if "smp" in kinds else -1
    return (lanes, clocks, np.tile(np.asarray(kind_pool), (B, 1)),
            np.full((B,), smp), fg.n)


def inert_padding(lanes, T_pad, dummy):
    """``lanes`` padded to ``T_pad`` steps the way ``_scan_cohorts`` pads
    the task axis: invalid steps on the dummy row, no options, dummy
    successors."""
    T = lanes["r"].shape[0]
    fill = {"valid": False, "r": dummy, "c": -1, "own_opts": -1,
            "par_opts": -1, "succ": dummy}
    out = {}
    for k, v in lanes.items():
        pad = np.full((T_pad - T,) + v.shape[1:], fill.get(k, 0),
                      dtype=v.dtype)
        out[k] = np.concatenate([v, pad])
    return out


def bits(*arrays):
    return [np.ascontiguousarray(a).tobytes() for a in arrays]


@pytest.mark.parametrize("T", [5, torchsim.STEPS, 45])
@pytest.mark.parametrize("policy", ["availability", "eft"])
def test_step_body_is_bitwise_the_old_step_loop(T, policy):
    """The packed U-step body — through a runner's static buffers, padded
    to a multiple of ``STEPS`` with inert steps, and run eagerly on the
    unpadded slice — gives bit for bit what the old step loop gives on the
    same inputs, with ``T`` below, equal to and not a multiple of
    ``STEPS``."""
    _, fg = both_frozen(40, True)
    _, systems = zynq_pair(range(1, 9))
    lanes, clocks, kind_pool, smp_kid, dummy = lane_inputs(
        fg, systems, T, policy)
    eft = policy == "eft"
    P, S, B = clocks.shape
    rows = dummy + 1
    K, NK = lanes["own_opts"].shape[2], lanes["own_cost"].shape[2]
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in lanes.items()}
    mk, busy, seen, place, div = legacy_run(
        t, torch.from_numpy(clocks.copy()),
        torch.zeros((rows, B), dtype=torch.float64),
        torch.full((rows, B), -1, dtype=torch.int32),
        torch.zeros((P, B), dtype=torch.float64),
        torch.zeros((P, B), dtype=torch.bool),
        torch.from_numpy(kind_pool), torch.from_numpy(smp_kid), eft)
    want = bits(div, mk, busy, seen, place)

    kp, sk = torch.from_numpy(kind_pool), torch.from_numpy(smp_kid)
    T_pad = -(-T // torchsim.STEPS) * torchsim.STEPS
    blocks = [torch.from_numpy(b) for b in torchsim._pack(
        inert_padding(lanes, T_pad, dummy))]
    runner = torchsim.StepRunner((P, S, B, rows, blocks[0].shape[1], NK, K),
                                 torch.device("cpu"), eft,
                                 torchsim.CompileCache())
    assert runner.graph is None and runner.libraries == ()
    assert bits(*runner.run(*blocks, clocks, kp, sk)) == want
    assert bits(*runner.run(*blocks, clocks, kp, sk)) == want   # reused

    st = torchsim._State(P, S, B, rows, torch.device("cpu"))
    st.reset(clocks)
    torchsim._steps(*(torch.from_numpy(b) for b in torchsim._pack(lanes)),
                    st, kp, sk, eft, K)
    assert bits(*st.outputs()) == want


def spy_runs(monkeypatch):
    """Every slice a step runner runs from now on, as ``(runner,
    arguments, outputs)``."""
    calls = []
    run = torchsim.StepRunner.run

    def spied(self, *args):
        out = run(self, *args)
        calls.append((self, args, out))
        return out

    monkeypatch.setattr(torchsim.StepRunner, "run", spied)
    return calls


def eager(runner, xi, xf, xb, clocks, kind_pool, smp_kid, npred=None,
          own=None, cohort=None):
    """The slice ``runner.run`` was given, through ``torchsim._steps`` on
    a fresh state: host copies of ``(div, makespan, busy, seen,
    placement)``."""
    P, S, B = runner.state.clocks.shape
    st = torchsim._State(P, S, B, runner.state.ready.shape[0], xi.device)
    st.reset(clocks, npred, own, cohort)
    torchsim._steps(xi, xf, xb, st, kind_pool, smp_kid, runner.eft,
                    runner.K)
    return st.outputs()


def test_repeat_sweep_through_a_shared_cache_captures_nothing_new(
        jaxsim, monkeypatch):
    """``simulate_torch(..., compile_cache=cc)`` twice on the same shapes:
    no new compile and at least one memory hit (as
    ``tests/test_megabatch.py``'s compile-cache test); the results within
    the tier of ``batch`` and rankings equivalent to ``simulate_jax_many``'s;
    each slice the runners ran, run again eagerly on a fresh state
    (``torchsim._steps``), bit for bit the runner's outputs."""
    from repro_torch.core import batchsim
    fg_ref, fg = both_frozen(24, True)
    ref_systems, systems = zynq_pair(range(1, 13))
    runs = spy_runs(monkeypatch)
    cc = torchsim.CompileCache()
    first = torchsim.simulate_torch(fg, systems, device="cpu",
                                    min_lockstep=2, compile_cache=cc)
    compiles = cc.as_dict()["compiles"]
    assert compiles >= 1
    again = torchsim.simulate_torch(fg, systems, device="cpu",
                                    min_lockstep=2, compile_cache=cc)
    assert cc.as_dict()["compiles"] == compiles
    assert cc.as_dict()["mem_hits"] >= 1
    assert [(s.makespan, s.placements) for s in again] == \
        [(s.makespan, s.placements) for s in first]
    assert len(runs) >= 2
    for runner, args, out in runs:
        assert bits(*out) == bits(*eager(runner, *args))
    batch = batchsim.simulate_batch(fg, systems, "availability",
                                    min_lockstep=2)
    for g, r in zip(first, batch):
        assert g.placements == r.placements
        assert replay.makespans_close(g.makespan, r.makespan,
                                      torchsim.TORCH_RTOL)
    jax_sims = jaxsim.simulate_jax_many([(fg_ref, ref_systems)],
                                        "availability", min_lockstep=2)[0]
    assert_tier(first, jax_sims, ref_systems)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [torchsim.MEGABATCH_CHUNK, 8])
def test_graph_sweep_is_bitwise_the_eager_sweep_on_the_card(monkeypatch,
                                                            chunk):
    """On the card each slice's captured step graphs give what the eager
    loop (``torchsim._steps`` on a fresh state, one fused launch a step)
    gives on the same slice, bit for bit (the same kernels in the same
    order, f64), with the launches credited at each replay equal to the
    eager launches by shape; a repeat sweep captures nothing new and
    gives the same results, counts and launches.  At ``chunk`` 8 the
    sweep splits into several slices and slot buckets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import lockstep_step
    _, fg = both_frozen(40, True)
    _, systems = zynq_pair(range(1, 25))
    runs = spy_runs(monkeypatch)
    cc = torchsim.CompileCache()

    def sweep():
        lockstep_step.LAUNCHES = 0
        lockstep_step.SHAPES.clear()
        stats = replay.BatchStats()
        got = torchsim.simulate_torch(fg, systems, device="cuda",
                                      min_lockstep=2, chunk=chunk,
                                      stats=stats, compile_cache=cc)
        return ([(s.makespan, s.busy, s.placements) for s in got],
                stats.as_dict(), lockstep_step.LAUNCHES,
                dict(lockstep_step.SHAPES))

    first = sweep()
    assert first[2] > 0 and runs
    captures = cc.as_dict()["captures"]
    assert captures >= 1 and cc.as_dict()["replays"] >= 1
    credited = collections.Counter()
    for runner, args, out in runs:
        with lockstep_step.recording() as tally:
            want = eager(runner, *args)
        assert bits(*out) == bits(*want)
        replays = args[0].shape[0] // torchsim.STEPS
        assert tally == collections.Counter(
            {shape: n * replays for shape, n in runner.launches.items()})
        credited.update(tally)
    assert dict(credited) == first[3]
    runs.clear()
    assert sweep() == first
    assert cc.as_dict()["captures"] == captures
