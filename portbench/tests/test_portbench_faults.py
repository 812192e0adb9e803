"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: an answer altered where the torch
engine produces it, and half of the candidates left out of the sweep.
The cells run on one card, so no exchange between chips can be left
out.  A step that leaves the state unchanged cannot reach a wrong
answer: the replay protocol's order check sends every lane to the exact
serial path (``test_frozen_step_falls_back``); a mix that asks for lanes
in lockstep on the card (``min_lockstep_share``) then fails its sweeps."""
from __future__ import annotations

import pytest

from portbench.tests.helpers import CELLS, cpu_run, small_cell


def altered_answer(monkeypatch):
    from repro_torch.core import torchsim
    inner = torchsim.simulate_torch_many

    def wrong(*args, **kwargs):
        out = inner(*args, **kwargs)
        sim = out[0][0]
        sim.makespan *= 1 + 1e-4
        return out

    monkeypatch.setattr(torchsim, "simulate_torch_many", wrong)


def half_left_out(monkeypatch):
    from repro_torch.core.explore import Explorer
    inner = Explorer.explore

    def half(self, candidates, **kwargs):
        cands = list(candidates)
        return inner(self, cands[: len(cands) // 2], **kwargs)

    monkeypatch.setattr(Explorer, "explore", half)


def frozen_step(monkeypatch):
    """The step-commit returns the end times but commits nothing: every
    lane's clocks, busy and seen stay as they were."""
    from repro_torch.core import torchsim

    def frozen(clocks, busy, seen, p, rt, base, live):
        import torch
        B = clocks.shape[2]
        lanes = torch.arange(B, device=clocks.device)
        tmin = clocks[p, :, lanes].min(dim=1).values
        return torch.maximum(rt, tmin) + base

    monkeypatch.setattr(torchsim, "step_commit", frozen)


@pytest.mark.parametrize("fault", [altered_answer, half_left_out],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    cell = small_cell(name)
    fault(monkeypatch)
    r = cpu_run(cell, seed=77)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_frozen_step_falls_back(name, monkeypatch):
    import time
    from portbench import harness
    cell = small_cell(name)
    frozen_step(monkeypatch)
    r = harness.run_cell(cell, 78, 0.5, True, "cpu", time.perf_counter())
    share = r["metrics"].get("lockstep_lane_share", {"value": 0.0})
    assert share["value"] == 0.0
    asks = cell["traffic"]["min_lockstep_share"] > 0
    assert r["correct"] is not asks, r["checks"]
    assert (r["failed"] == r["attempted"]) is asks
