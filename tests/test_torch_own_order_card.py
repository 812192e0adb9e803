"""Own-order lanes of the torch engine on the card: the benchmark's matmul
design space through the megabatch, held to ``simulate_fast``.  Imports
nothing of the JAX package; run on the card with ``python -m pytest -q -m
gpu tests/test_torch_own_order_card.py``."""
import pytest
import torch

from repro_torch.core import fastsim, replay, torchsim

from own_order_common import matmul512_space

RTOL = replay.TORCH_RTOL


@pytest.mark.gpu
def test_own_order_lanes_on_the_card_are_simulate_fast():
    """On the card, the matmul's 134 candidates over two calls on one
    library (the first all own-order but each group's discovery): every
    lane within the tier of ``simulate_fast``, placements exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fams = matmul512_space()
    lib = replay.ReplayLibrary()
    for _ in range(2):
        stats = replay.BatchStats()
        got = torchsim.simulate_torch_many(fams, device="cuda", stats=stats,
                                           library=lib)
        assert stats.own_order_lanes > 0
        for (fg, systems), sims in zip(fams, got):
            for s, sim in zip(systems, sims):
                want = fastsim.simulate_fast(fg, s, "availability")
                assert sim.placements == want.placements, s.name
                assert replay.makespans_close(sim.makespan, want.makespan,
                                              RTOL), s.name


def explore_twice(inp, config, device):
    """A cold sweep of the whole design space of a benchmark
    configuration, then a warm one on the same order library, through
    ``Explorer(engine="torch")`` on ``device``: each sweep's ranked
    ``(name, makespan)`` pairs and ``BatchStats``."""
    from portbench import port
    from repro_torch.core.explore import Explorer
    trace = port.trace(inp["events"])
    reports = port.reports(inp["reports"])
    cands = port.candidates(inp["design_space"], inp["system"], reports)
    lib = replay.ReplayLibrary()
    out = []
    for _ in range(2):
        ex = Explorer(trace, reports, engine="torch", device=device,
                      smp_seconds_fn=port.smp_seconds_fn(inp["smp"]),
                      order_library=lib, budget=config["fabric_budget"])
        res = ex.explore(cands, top_k=3)
        assert ex.engine == "torch"
        out.append(([(o.name, o.makespan_s) for o in res.ranked],
                    ex.batch_stats.as_dict()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cholesky512_bs64", "matmul512_bs64"])
def test_fused_sweeps_hold_the_plain_bodys_results(name):
    """Both benchmark configurations' design spaces, swept cold and warm
    on the card (one fused launch a step, in the step graphs) and on the
    CPU (the plain body, which the earlier step loop ran on the card op
    for op): the same ranking, makespans bit for bit, the same
    ``BatchStats``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    from pathlib import Path
    from portbench import apps
    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "portbench" / "configs"
                         / f"{name}.json").read_text())
    inp = apps.inputs(config)
    card = explore_twice(inp, config, "cuda")
    assert card == explore_twice(inp, config, "cpu")
    assert card[1][1]["own_order_lanes"] > 0
