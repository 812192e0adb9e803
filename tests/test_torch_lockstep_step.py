"""The port's step-commit: plain version vs the Pallas kernel, and the card.

``repro_torch.kernels.lockstep_step.step_commit_ref`` is the plain PyTorch
version of the Hopper kernel; it is held bit for bit (f64, no tolerance:
the commit has no multiply, so nothing can round differently) to the
JAX package's Pallas kernel in interpret mode and to the numpy
transcription of the commit in ``tests/test_megabatch.py``.  Inputs are
seeded numpy states with ties, all-``inf`` pools and dead lanes.  The
kernel itself runs only on a card (``-m gpu``); JAX is imported only by
the tests that run the Pallas kernel, so the card's tests need none.
"""
import numpy as np
import pytest
import torch

from repro_torch import DeviceError
from repro_torch.kernels import lockstep_step as ls

SHAPES = [(3, 4, 16), (2, 64, 256), (4, 16, 256), (3, 5, 128), (1, 1, 8)]


def seeded_state(seed, P, S, B):
    """Small integer clocks (ties on every lane), slots past half the axis
    at ``inf`` on every third lane, the last pool all ``inf`` on every
    fifth lane (``end - start`` is then ``inf - inf``)."""
    rng = np.random.default_rng(seed)
    clocks = rng.integers(0, 4, (P, S, B)).astype(np.float64)
    clocks[:, (S + 1) // 2:, ::3] = np.inf
    clocks[P - 1, :, ::5] = np.inf
    busy = rng.random((P, B))
    seen = rng.random((P, B)) < 0.5
    p = rng.integers(0, P, B).astype(np.int64)
    rt = rng.integers(0, 4, B).astype(np.float64)
    base = rng.random(B)
    live = rng.random(B) < 0.75
    return clocks, busy, seen, p, rt, base, live


def run_ref(state):
    t = [torch.from_numpy(a.copy()) for a in state]
    end = ls.step_commit_ref(*t)
    return [x.numpy() for x in t[:3]] + [end.numpy()]


def same_bits(a, b):
    """Equal values, NaN where the other has NaN (payloads aside)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == bool:
        return np.array_equal(a, b)
    return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("P,S,B", SHAPES)
def test_ref_matches_pallas_kernel_in_interpret_mode(P, S, B):
    import jax
    import jax.numpy as jnp
    from repro.kernels.lockstep_step import step_commit as pallas_commit
    state = seeded_state(P * 1000 + S, P, S, B)
    want = run_ref(state)
    with jax.enable_x64(True):
        got = pallas_commit(*(jnp.asarray(a) for a in state), interpret=True)
        got = [np.asarray(g) for g in got]
    for name, g, w in zip(("clocks", "busy", "seen", "end"), got, want):
        assert g.dtype == w.dtype, name
        assert same_bits(g, w), name


@pytest.mark.parametrize("P,S,B", SHAPES)
def test_ref_matches_numpy_oracle(P, S, B):
    """The direct numpy transcription of the commit, lane by lane."""
    clocks, busy, seen, p, rt, base, live = seeded_state(P + S + B, P, S, B)
    oclk, obusy, oseen, oend = run_ref((clocks, busy, seen, p, rt, base,
                                        live))
    for li in range(B):
        cl = clocks[p[li], :, li]
        s = int(np.argmin(cl))                  # first minimum
        start = max(rt[li], cl[s])
        end = start + base[li]
        assert same_bits(oend[li], end)
        want_clk = clocks[:, :, li].copy()
        want_busy = busy[:, li].copy()
        want_seen = seen[:, li].copy()
        if live[li]:
            want_clk[p[li], s] = end
            with np.errstate(invalid="ignore"):     # inf - inf: all-inf pool
                want_busy[p[li]] += end - start
            want_seen[p[li]] = True
        assert same_bits(oclk[:, :, li], want_clk)
        assert same_bits(obusy[:, li], want_busy)
        assert same_bits(oseen[:, li], want_seen)


def test_all_inf_pool_gives_nan_busy_only_on_live_lanes():
    """The pool with no free slot: start = end = inf, busy turns NaN on a
    live lane (the scan flags such rows bad_row and discards the lane),
    clocks never turn NaN."""
    clocks = np.full((1, 3, 2), np.inf)
    state = (clocks, np.zeros((1, 2)), np.zeros((1, 2), bool),
             np.zeros(2, np.int64), np.zeros(2), np.ones(2),
             np.array([True, False]))
    oclk, obusy, oseen, oend = run_ref(state)
    assert np.isinf(oend).all() and np.isinf(oclk).all()
    assert np.isnan(obusy[0, 0]) and obusy[0, 1] == 0.0
    assert oseen.tolist() == [[True, False]]


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    state = seeded_state(3, 2, 8, 16)
    want = run_ref(state)
    t = [torch.from_numpy(a.copy()) for a in state]
    before, shapes = ls.LAUNCHES, dict(ls.SHAPES)
    end = ls.step_commit(*t)
    assert ls.LAUNCHES == before and ls.SHAPES == shapes
    for g, w in zip([x.numpy() for x in t[:3]] + [end.numpy()], want):
        assert same_bits(g, w)


@pytest.mark.parametrize("field,bad", [
    ("clocks", torch.zeros(2, 4, 8, dtype=torch.float32)),
    ("busy", torch.zeros(2, 7, dtype=torch.float64)),
    ("seen", torch.zeros(2, 8, dtype=torch.uint8)),
    ("p", torch.zeros(8, dtype=torch.int32)),
    ("rt", torch.zeros(16, dtype=torch.float64)[::2]),
    ("live", torch.zeros(8, dtype=torch.float64)),
])
def test_wrapper_checks_reject_bad_arguments(field, bad):
    """What the kernel does not take is refused before any pointer is
    handed to it: wrong dtype, shape or a non-contiguous view.  The refusal
    is a DeviceError, so a sweep on the card fails instead of demoting."""
    args = {"clocks": torch.zeros(2, 4, 8, dtype=torch.float64),
            "busy": torch.zeros(2, 8, dtype=torch.float64),
            "seen": torch.zeros(2, 8, dtype=torch.bool),
            "p": torch.zeros(8, dtype=torch.int64),
            "rt": torch.zeros(8, dtype=torch.float64),
            "base": torch.zeros(8, dtype=torch.float64),
            "live": torch.zeros(8, dtype=torch.bool)}
    ls._check(**args)
    args[field] = bad
    with pytest.raises(DeviceError, match=field):
        ls._check(**args)


def test_wrapper_refuses_devices_without_a_kernel():
    t = [torch.from_numpy(a.copy()).to("meta")
         for a in seeded_state(0, 2, 4, 8)]
    with pytest.raises(DeviceError, match="no kernel"):
        ls.step_commit(*t)


@pytest.mark.gpu
@pytest.mark.parametrize("P,S,B", SHAPES)
def test_kernel_matches_plain_version_on_the_card(P, S, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state = seeded_state(P * 7 + S, P, S, B)
    ref = [torch.from_numpy(a.copy()).cuda() for a in state]
    dev = [torch.from_numpy(a.copy()).cuda() for a in state]
    end_ref = ls.step_commit_ref(*ref)
    before = ls.LAUNCHES
    end_dev = ls.step_commit(*dev)
    torch.cuda.synchronize()
    assert ls.LAUNCHES == before + 1
    for g, w in zip(dev[:3] + [end_dev], ref[:3] + [end_ref]):
        assert same_bits(g.cpu().numpy(), w.cpu().numpy())
