"""The port's torch engine against the JAX package's engines.

``repro_torch.core.torchsim`` is pinned at the relaxed tier: makespans and
busy sums within ``1e-6`` relative of the reference (``sims_equivalent``
at 1e-6 — the same tier as ``JAX_RTOL``; the state is f64 end to end, so
the residual is float reordering only), placements and pool layouts
exact.  Every population is built with the JAX package and the port from
the same seeded inputs, and the port's results are held to the JAX
package's ``simulate_fast``, ``simulate_jax(step_impl="lax")`` and
``simulate_jax_many``.  The torch engine runs on the CPU here
(``device="cpu"``); the card runs the ``gpu`` tests.
"""
import pickle

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
from repro_torch.testing import synth

#: Same tier as ``JAX_RTOL``; f64 end to end.
RTOL = 1e-6


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
    want = jaxsim.simulate_jax(fg_ref, ref_systems, policy, min_lockstep=2,
                               step_impl="lax")
    stats_ref, stats = ref_replay.BatchStats(), replay.BatchStats()
    jaxsim.simulate_jax(fg_ref, ref_systems, policy, min_lockstep=2,
                        step_impl="lax", stats=stats_ref)
    got = torchsim.simulate_torch(fg, systems, policy, device="cpu",
                                  min_lockstep=2, stats=stats)
    assert_tier(got, want, ref_systems)
    assert_tier(got, fast_refs(fg_ref, ref_systems, policy), ref_systems)
    # the same replay protocol routed the same lanes the same way
    assert stats.as_dict() == stats_ref.as_dict()
    assert stats.lockstep_lanes > 0


def test_torch_many_matches_jax_many(jaxsim):
    """The megabatch: heterogeneous graphs (±SMP, two sizes) share one
    lane axis; per family the results match the JAX megabatch's and the
    per-graph engine's."""
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

    def run(eng, mod, sys_, fg_, **kw):
        inc = mod.Incumbent(3, seed=cut)
        return eng(fg_, sys_, "availability", min_lockstep=2,
                   prune=mod.PruneContext(inc, None, RTOL), **kw)

    want = run(jaxsim.simulate_jax, ref_replay, ref_systems, fg_ref,
               step_impl="lax")
    got = run(torchsim.simulate_torch, replay, systems, fg, device="cpu")
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
    """A wide slot ramp forces event-order divergence; diverged lanes are
    re-simulated through the exact path (bit-identical), the rest stay in
    the loop."""
    fg_ref, fg = both_frozen(40, True)
    ref_systems, systems = zynq_pair(range(1, 25))
    stats = replay.BatchStats()
    got = torchsim.simulate_torch(fg, systems, "availability",
                                  device="cpu", min_lockstep=2, stats=stats)
    refs = fast_refs(fg_ref, ref_systems, "availability")
    assert_tier(got, refs, ref_systems)
    assert stats.diverged_lanes > 0 and stats.lockstep_lanes > 0
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


def test_scan_inputs_memoised_and_dropped_on_pickling():
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
