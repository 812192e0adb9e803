"""The port's Explorer and CLI against the JAX package's.

``repro_torch``'s ``Explorer(engine="torch", device="cpu")`` is held to the
JAX package's ``Explorer(engine="jax")`` and ``engine="batch"`` on the
README quickstart sweep and on the paper's Cholesky at ``n=256, bs=64``:
equal best candidates and ``rankings_equivalent`` at 1e-6 (same tier as
``JAX_RTOL``; f64 end to end), frontiers at the same tier in PPA mode.
The copied exact engines (``fast``/``batch``) must stay bit-identical to
the reference's.  A card that is missing, a kernel that fails to build and
a kernel launch that fails raise ``DeviceError`` and never demote.
"""
import importlib
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from repro.apps import cholesky as ref_ch
from repro.core import Explorer as RefExplorer
from repro.core import a9_smp_seconds as ref_a9
from repro.testing import synth as ref_synth

from repro_torch import DeviceError
from repro_torch.apps import cholesky as ch
from repro_torch.core import Explorer, a9_smp_seconds, torchsim
from repro_torch.core.replay import (TORCH_RTOL, frontiers_equivalent,
                                     rankings_equivalent)
from repro_torch.explore import main as cli_main
from repro_torch.kernels import lockstep_step
from repro_torch.testing import faults, synth

#: Same tier as ``JAX_RTOL``; f64 end to end.
RTOL = 1e-6

explore_mod = importlib.import_module("repro_torch.core.explore")


@pytest.fixture
def jaxsim(monkeypatch):
    """``repro.core.jaxsim``, runnable on the installed JAX (see
    ``tests/test_torch_torchsim.py``): supplies ``jax.experimental.
    enable_x64`` where JAX now calls it ``jax.enable_x64`` and clears the
    engine's cached import failure, both for the test's duration."""
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


def quickstart():
    """The README quickstart's sweep, built by each package."""
    ref = (ref_synth.synth_trace(24), ref_synth.synth_reports(),
           ref_synth.synth_candidates(range(1, 7)), {})
    port = (synth.synth_trace(24), synth.synth_reports(),
            synth.synth_candidates(range(1, 7)), {})
    return ref, port


def cholesky_ramp(mod_ch, a9, slots=6):
    """``trace_cholesky(256, 64)`` with the six Fig. 9 designs, each at
    1..``slots`` slots per accelerator pool (a design alone is a one-lane
    family, which never reaches the lockstep engines)."""
    from importlib import import_module
    devices = import_module(mod_ch.__name__.rsplit(".", 2)[0]
                            + ".core.devices")
    cands = []
    for base in mod_ch.candidates(bs=64):
        for k in range(1, slots + 1):
            name = f"{base.name}x{k}"
            counts = {kind: n * k for kind, n
                      in base.system.meta["accelerators"].items()}
            cands.append(type(base)(name=name,
                                    system=devices.zynq_system(name, counts),
                                    eligibility=base.eligibility))
    return (mod_ch.trace_cholesky(n=256, bs=64), mod_ch.report_map(bs=64),
            cands, {"smp_seconds_fn": a9("float64")})


WORKLOADS = {
    "quickstart": quickstart,
    "cholesky256": lambda: (cholesky_ramp(ref_ch, ref_a9),
                            cholesky_ramp(ch, a9_smp_seconds)),
}


def ranked(res):
    return [o.name for o in res.ranked]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_torch_explorer_matches_reference_jax_and_batch(jaxsim, workload):
    (rtr, rrep, rcands, rkw), (tr, rep, cands, kw) = WORKLOADS[workload]()
    ref_batch = RefExplorer(rtr, rrep, engine="batch", **rkw).explore(
        rcands, top_k=3)
    ref_jax_ex = RefExplorer(rtr, rrep, engine="jax", **rkw)
    ref_jax = ref_jax_ex.explore(rcands, top_k=3)
    assert ref_jax_ex.engine == "jax"
    ex = Explorer(tr, rep, engine="torch", device="cpu", **kw)
    got = ex.explore(cands, top_k=3)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0
    assert ex.batch_stats.lockstep_lanes > 0
    spans = {o.name: o.makespan_s for o in ref_batch.ranked}
    for want in (ref_batch, ref_jax):
        assert got.best_name == want.best_name
        assert rankings_equivalent(ranked(got), ranked(want), spans, RTOL)
    assert [o.status for o in got.outcomes] == \
        [o.status for o in ref_batch.outcomes]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_torch_pruned_top_k_matches_reference(jaxsim, workload):
    """``prune=True``: the top-k is held to the *unpruned* exact sweep (the
    pruned exact engines may retire a lane whose makespan ties the k-th
    best exactly, so their pruned best can be a different one of the
    tied candidates) and, pruned set and all, to the JAX engine's."""
    (rtr, rrep, rcands, rkw), (tr, rep, cands, kw) = WORKLOADS[workload]()
    exact = RefExplorer(rtr, rrep, engine="batch", **rkw).explore(
        rcands, top_k=3)
    ref_jax = RefExplorer(rtr, rrep, engine="jax", **rkw).explore(
        rcands, top_k=3, prune=True)
    ex = Explorer(tr, rep, engine="torch", device="cpu", **kw)
    got = ex.explore(cands, top_k=3, prune=True)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0
    spans = {o.name: o.makespan_s for o in exact.ranked}
    assert got.best_name == exact.best_name == ref_jax.best_name
    assert rankings_equivalent(ranked(got)[:3], ranked(exact)[:3], spans,
                               RTOL)
    assert [o.status for o in got.outcomes] == \
        [o.status for o in ref_jax.outcomes]
    kth = exact.ranked[2].makespan_s
    for o in got.outcomes:
        if o.status == "pruned":
            assert spans[o.name] > kth


def test_torch_explorer_frontier_matches_reference(jaxsim):
    """PPA mode: the Pareto frontier is stable at the tier."""
    (rtr, rrep, rcands, _), (tr, rep, cands, _) = quickstart()
    cfg = {"objectives": ["area_mm2", "energy_j"],
           "budgets": {"power_w": 5.0}}
    ref = RefExplorer(rtr, rrep, engine="batch", **cfg).explore(rcands,
                                                               top_k=3)
    ref_jax = RefExplorer(rtr, rrep, engine="jax", **cfg).explore(rcands,
                                                                 top_k=3)
    got = Explorer(tr, rep, engine="torch", device="cpu", **cfg).explore(
        cands, top_k=3)
    assert got.objectives == ref.objectives
    objs = {o.name: o.objectives for o in ref.ranked}
    for want in (ref, ref_jax):
        assert frontiers_equivalent([o.name for o in got.frontier],
                                    [o.name for o in want.frontier],
                                    objs, ref.objectives, RTOL)
    for o in got.ranked:
        assert o.objectives["area_mm2"] == objs[o.name]["area_mm2"]
        assert o.objectives["power_w"] == objs[o.name]["power_w"]


@pytest.mark.parametrize("engine", ["fast", "batch"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_copied_exact_engines_bit_identical_to_reference(engine, workload):
    (rtr, rrep, rcands, rkw), (tr, rep, cands, kw) = WORKLOADS[workload]()
    want = RefExplorer(rtr, rrep, engine=engine, **rkw).explore(rcands,
                                                               top_k=3)
    got = Explorer(tr, rep, engine=engine, **kw).explore(cands, top_k=3)
    assert [(o.name, o.status, o.makespan_s, o.critical_path_s,
             o.lower_bound_s, o.bottleneck) for o in got.outcomes] == \
        [(o.name, o.status, o.makespan_s, o.critical_path_s,
          o.lower_bound_s, o.bottleneck) for o in want.outcomes]
    assert ranked(got) == ranked(want)
    for name, est in got.estimates.items():
        ref_sim = want.estimates[name].sim
        assert est.sim.busy == ref_sim.busy
        assert est.sim.placements == ref_sim.placements


# ---------------------------------------------------------------------------
# the device is never replaced, the kernel never bypassed
# ---------------------------------------------------------------------------


def test_default_engine_is_torch_on_the_card():
    tr, rep = synth.synth_trace(8), synth.synth_reports()
    assert explore_mod.ENGINE_NAMES == ("reference", "fast", "batch",
                                        "torch")
    if torch.cuda.is_available():
        ex = Explorer(tr, rep)
        assert ex.engine == "torch" and ex.device.type == "cuda"
    else:
        with pytest.raises(DeviceError):
            Explorer(tr, rep)
    # legacy spellings resolve to the exact engines
    assert Explorer(tr, rep, batch=True).engine == "batch"
    assert Explorer(tr, rep, batch=False).engine == "fast"
    assert Explorer(tr, rep, fast=False).engine == "reference"


def test_cuda_without_a_card_raises_and_never_demotes():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tr, rep = synth.synth_trace(8), synth.synth_reports()
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no demotion warning either
        for device in (None, "cuda"):
            with pytest.raises(DeviceError, match="CUDA"):
                Explorer(tr, rep, engine="torch", device=device)
            with pytest.raises(DeviceError):
                explore_mod.explore(tr, synth.synth_candidates(range(1, 4)),
                                    rep, engine="torch", device=device)


@pytest.mark.parametrize("megabatch", [True, False])
@pytest.mark.parametrize("error", [
    DeviceError("injected: step_commit kernel launch failed"),
    torch.OutOfMemoryError("injected: CUDA out of memory")])
def test_kernel_failure_mid_sweep_raises_and_never_demotes(monkeypatch,
                                                           megabatch, error):
    """A kernel build or launch failure, or the card failing under the
    step loop, surfaces as DeviceError from the sweep: no demotion to
    batch, no per-candidate isolation on the host."""
    def broken(*args):
        raise error

    monkeypatch.setattr(torchsim, "step_commit", broken)
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    ex = Explorer(tr, rep, engine="torch", device="cpu",
                  torch_megabatch=megabatch)
    with pytest.raises(DeviceError, match="injected"):
        ex.explore(synth.synth_candidates(range(1, 9)), top_k=3)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0


@pytest.mark.parametrize("megabatch", [True, False])
def test_other_engine_faults_keep_the_torch_to_batch_demotion(monkeypatch,
                                                              megabatch):
    def broken(*args):
        raise RuntimeError("injected lockstep bug")

    monkeypatch.setattr(torchsim, "step_commit", broken)
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    cands = synth.synth_candidates(range(1, 9))
    ex = Explorer(tr, rep, engine="torch", device="cpu",
                  torch_megabatch=megabatch)
    with pytest.warns(UserWarning, match="degraded to 'batch'"):
        got = ex.explore(cands, top_k=3)
    assert ex.engine == "batch" and ex.stats.engine_demotions == 1
    want = Explorer(tr, rep, engine="batch").explore(cands, top_k=3)
    assert ranked(got) == ranked(want)


@pytest.mark.parametrize("megabatch", [True, False])
def test_engine_faults_on_the_card_raise_and_never_demote(monkeypatch,
                                                          megabatch):
    """On the card, a fault of the torch engine mid-sweep that is not a
    DeviceError re-raises as it is: the sweep neither moves to the host's
    batch engine nor isolates its candidates there.  (The Explorer runs on
    the CPU and is told it is on the card.)"""
    def broken(*args):
        raise RuntimeError("injected lockstep bug")

    monkeypatch.setattr(torchsim, "step_commit", broken)
    monkeypatch.setattr(explore_mod.Explorer, "_on_card", lambda self: True)
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    ex = Explorer(tr, rep, engine="torch", device="cpu",
                  torch_megabatch=megabatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no demotion warning
        with pytest.raises(RuntimeError, match="injected lockstep bug"):
            ex.explore(synth.synth_candidates(range(1, 9)), top_k=3)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0
    assert ex.stats.quarantined == 0


@pytest.mark.gpu
@pytest.mark.parametrize("megabatch", [True, False])
def test_bad_tensor_for_the_kernel_fails_the_sweep_on_the_card(monkeypatch,
                                                               megabatch):
    """A tensor the fused step's wrapper refuses (here ``kind_pool`` as
    int32) stops a sweep on the card with DeviceError and no demotion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fused = lockstep_step.step_fused

    def int32_pools(xi, xf, xb, state, kind_pool, *rest):
        return fused(xi, xf, xb, state, kind_pool.to(torch.int32), *rest)

    monkeypatch.setattr(lockstep_step, "step_fused", int32_pools)
    # the wrapper runs when a step graph is captured (a graph captured
    # earlier in the process replays without it): an empty compile cache
    monkeypatch.setattr(torchsim, "_DEFAULT_CACHE", torchsim.CompileCache())
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    ex = Explorer(tr, rep, engine="torch", device="cuda",
                  torch_megabatch=megabatch)
    with pytest.raises(DeviceError, match="kind_pool must be torch.int64"):
        ex.explore(synth.synth_candidates(range(1, 9)), top_k=3)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0


@pytest.mark.gpu
@pytest.mark.parametrize("megabatch", [True, False])
def test_any_engine_fault_on_the_card_raises_and_never_demotes(monkeypatch,
                                                               megabatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def broken(*args):
        raise RuntimeError("injected lockstep bug")

    # the card's steps are the fused step's launches
    monkeypatch.setattr(lockstep_step, "step_fused", broken)
    # as above: the fault is raised where a step graph is captured
    monkeypatch.setattr(torchsim, "_DEFAULT_CACHE", torchsim.CompileCache())
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    ex = Explorer(tr, rep, engine="torch", device="cuda",
                  torch_megabatch=megabatch)
    with pytest.raises(RuntimeError, match="injected lockstep bug"):
        ex.explore(synth.synth_candidates(range(1, 9)), top_k=3)
    assert ex.engine == "torch" and ex.stats.engine_demotions == 0


def test_injected_torch_activation_fault_demotes_to_batch():
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    with faults.install("fail_torch_import:1"):
        with pytest.warns(UserWarning, match="fail_torch_import"):
            ex = Explorer(tr, rep, engine="torch", device="cpu")
    assert ex.engine == "batch" and ex.stats.engine_demotions == 1
    assert ex.explore(synth.synth_candidates(range(1, 7))).best_name == "4acc"


def test_torch_engine_validation():
    tr, rep = synth.synth_trace(4), synth.synth_reports()
    with pytest.raises(ValueError, match="in-process"):
        Explorer(tr, rep, engine="torch", device="cpu", processes=2)
    with pytest.raises(ValueError, match="host threads"):
        Explorer(tr, rep, engine="torch", device="cpu", max_workers=4)
    for bad in (0, -4):
        with pytest.raises(ValueError, match="torch_chunk"):
            Explorer(tr, rep, engine="torch", device="cpu", torch_chunk=bad)
    for kw in ({"torch_chunk": 16}, {"torch_megabatch": True},
               {"device": "cpu"}):
        with pytest.raises(ValueError, match="only applies"):
            Explorer(tr, rep, engine="batch", **kw)
    with pytest.raises(ValueError, match="cuda"):
        Explorer(tr, rep, engine="torch", device="meta")


def test_torch_tier_never_leaks_into_exact_sim_cache(tmp_path):
    """torch-tier sims persist under their own ``sim-torch`` tag: an exact
    sweep over the same store recomputes and stays bit-identical, while
    an exact store serves torch re-ranks."""
    tr, rep = synth.synth_trace(24), synth.synth_reports()
    cands = synth.synth_candidates(range(1, 7), synth.synth_report())
    store = str(tmp_path / "store")
    got = Explorer(tr, rep, engine="torch", device="cpu",
                   cache_dir=store).explore(cands)
    exact = Explorer(tr, rep, engine="batch", cache_dir=store)
    res = exact.explore(cands)
    assert res.cache["disk_hits"] >= 1              # graphs are shared
    ref = Explorer(tr, rep, engine="fast").explore(cands)
    assert [(o.name, o.makespan_s) for o in res.ranked] == \
        [(o.name, o.makespan_s) for o in ref.ranked]
    spans = {o.name: o.makespan_s for o in ref.ranked}
    assert rankings_equivalent(ranked(got), ranked(ref), spans, TORCH_RTOL)
    rerank = Explorer(tr, rep, engine="torch", device="cpu",
                      cache_dir=store).explore(cands)
    assert rerank.cache["disk_hits"] >= len(cands)
    tags = {json.loads(t)[0] for t in [
        exact._sim_disk_text(explore_mod._graph_key(c.system, c.eligibility),
                             c.system, tier) for c in cands[:1]
        for tier in ("exact", "torch")]}
    assert tags == {"sim", "sim-torch"}


def test_pool_start_method_never_forks_after_cuda_init(monkeypatch):
    monkeypatch.delenv("REPRO_POOL_START", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert explore_mod._pool_mp_context().get_start_method() != "fork"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_runs_the_torch_engine_by_default_on_the_requested_device(
        capsys):
    rc = cli_main(["synth:24", "--accs", "1-6", "--top-k", "3",
                   "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["engine"] == "torch" and doc["engine_final"] == "torch"
    assert doc["best"] == "4acc" and len(doc["top"]) == 3


def test_cli_dispatches_the_service_and_refuses_a_missing_card(capsys):
    for sub in ("serve", "client"):
        with pytest.raises(SystemExit) as done:
            cli_main([sub, "--help"])
        assert done.value.code == 0
        assert f"python -m repro_torch.explore {sub}" in \
            capsys.readouterr().out
    if not torch.cuda.is_available():
        assert cli_main(["synth:8", "--accs", "1-2"]) == 2
        assert "CUDA" in capsys.readouterr().err


def test_cli_module_entrypoint_subprocess():
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.explore", "synth:12", "--accs",
         "1-4", "--top-k", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=True, env=env)
    doc = json.loads(out.stdout)
    assert doc["engine_final"] == "torch" and len(doc["top"]) == 2


@pytest.mark.gpu
def test_torch_explorer_on_the_card_matches_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (_, _, _, _), (tr, rep, cands, kw) = WORKLOADS["cholesky256"]()
    lockstep_step.LAUNCHES = 0
    ex = Explorer(tr, rep, **kw)                    # torch on the card
    got = ex.explore(cands, top_k=3)
    assert ex.device.type == "cuda" and lockstep_step.LAUNCHES > 0
    want = Explorer(tr, rep, engine="batch", **kw).explore(cands, top_k=3)
    spans = {o.name: o.makespan_s for o in want.ranked}
    assert got.best_name == want.best_name
    assert rankings_equivalent(ranked(got), ranked(want), spans, RTOL)
