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
