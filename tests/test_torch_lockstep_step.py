"""The port's step-commit: plain version vs the Pallas kernel, and the card.

``repro_torch.kernels.lockstep_step.step_commit_ref`` is the plain PyTorch
version of the Hopper kernel; it is held bit for bit (f64, no tolerance:
the commit has no multiply, so nothing can round differently) to the
JAX package's Pallas kernel in interpret mode and to the numpy
transcription of the commit in ``tests/test_megabatch.py``.  Inputs are
seeded numpy states with ties, all-``inf`` pools and dead lanes.  The
kernel itself runs only on a card (``-m gpu``); JAX is imported only by
the tests that run the Pallas kernel, so the card's tests need none.

The kernel splits each lane's pool across a group of ``group_size(S)``
threads and reduces their first-minima by an xor-shuffle tree; a plain
numpy mirror of that arithmetic, thread for thread, is held bit for bit
to ``step_commit_ref`` and to the numpy transcription at every group
size, on states whose ties and NaNs sit in different threads of a group.
The card route's host side (the packed argument block, the refusals) is
driven with CPU tensors through a stub library.
"""
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import DeviceError
from repro_torch.kernels import build
from repro_torch.kernels import lockstep_step as ls

SHAPES = [(3, 4, 16), (2, 64, 256), (4, 16, 256), (3, 5, 128), (1, 1, 8)]

#: Pool depths across every group size the kernel compiles (1 to 32
#: threads a lane), with S just below, at and above a warp.
GROUP_DEPTHS = [1, 5, 16, 31, 32, 33, 64, 128]


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


def adversarial_state(seed, P, S, B):
    """``seeded_state`` with, lane by lane in turn: two tied minima in
    different threads of the lane's group, two NaNs in different threads
    below a smaller number's slot, one NaN after the minimum, an all-+inf
    pool, and a tie between a slot of thread 0 and the pool's last slot."""
    clocks, busy, seen, p, rt, base, live = seeded_state(seed, P, S, B)
    rng = np.random.default_rng(seed + 1)
    G = ls.group_size(S)
    for b in range(B):
        col = clocks[p[b], :, b]
        col[:] = rng.integers(2, 6, S).astype(np.float64)
        kind = b % 5
        if kind == 0 and S > 1:
            j1 = int(rng.integers(0, S))
            j2 = (j1 + 1 + int(rng.integers(0, S - 1))) % S   # another slot
            if G > 1 and j1 % G == j2 % G:
                j2 = (j1 + 1) % S
            col[[j1, j2]] = 1.0
        elif kind == 1 and S > 2:
            col[S - 1] = 0.5
            j1, j2 = sorted(rng.choice(S - 1, 2, replace=False))
            col[[j1, j2]] = np.nan
        elif kind == 2:
            col[0] = 1.0
            col[S - 1] = np.nan
        elif kind == 3:
            col[:] = np.inf
        else:
            col[[0, S - 1]] = 1.0
    return clocks, busy, seen, p, rt, base, live


def _before(v, i, w, j):
    """The kernel's order of (value, slot) pairs: a NaN first (the lower
    slot among NaNs), then the smaller value, then the lower slot."""
    vn, wn = math.isnan(v), math.isnan(w)
    if vn != wn:
        return vn
    if not vn and v != w:
        return v < w
    return i < j


def _max_nan(a, b):
    if math.isnan(a):
        return a
    if math.isnan(b):
        return b
    return a if a > b else b


def group_mirror(state):
    """The kernel's arithmetic in numpy, thread for thread: thread g of the
    lane's group of ``G = group_size(S)`` keeps the first minimum of slots
    g, g + G, ... under ``_before``; the xor tree (offsets G/2 .. 1) leaves
    each thread the better of its pair and its partner's; thread 0
    commits.  Returns ``[clocks, busy, seen, end]``."""
    clocks, busy, seen, p, rt, base, live = (a.copy() for a in state)
    P, S, B = clocks.shape
    G = ls.group_size(S)
    end = np.empty(B)
    for b in range(B):
        col = clocks[p[b], :, b]
        best = []
        for g in range(G):
            v, i = math.inf, S
            for j in range(g, S, G):
                if _before(col[j], j, v, i):
                    v, i = col[j], j
            best.append((v, i))
        off = G // 2
        while off:
            best = [best[g ^ off] if _before(*best[g ^ off], *best[g])
                    else best[g] for g in range(G)]
            off //= 2
        tmin, s = best[0]
        start = _max_nan(rt[b], tmin)
        e = start + base[b]
        end[b] = e
        if live[b]:
            clocks[p[b], s, b] = e
            with np.errstate(invalid="ignore"):     # inf - inf: all-inf pool
                busy[p[b], b] = busy[p[b], b] + (e - start)
            seen[p[b], b] = True
    return [clocks, busy, seen, end]


def numpy_oracle(state):
    """The direct numpy transcription of the commit, lane by lane (the
    oracle of ``tests/test_megabatch.py``).  Returns ``[clocks, busy,
    seen, end]``."""
    clocks, busy, seen, p, rt, base, live = (a.copy() for a in state)
    end = np.empty(len(p))
    for li in range(len(p)):
        cl = state[0][p[li], :, li]
        s = int(np.argmin(cl))                  # first minimum
        start = _max_nan(rt[li], cl[s])
        end[li] = start + base[li]
        if live[li]:
            clocks[p[li], s, li] = end[li]
            with np.errstate(invalid="ignore"):     # inf - inf: all-inf pool
                busy[p[li], li] += end[li] - start
            seen[p[li], li] = True
    return [clocks, busy, seen, end]


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


@pytest.mark.parametrize("S", GROUP_DEPTHS)
def test_group_reduction_mirror_matches_ref_and_numpy_oracle(S):
    """The kernel's split of a pool across its thread group gives the same
    commit as the sequential scan, bit for bit, at every group size: on
    seeded states and on states whose tied minima and NaNs sit in
    different threads of a group, with all-+inf pools."""
    for state in (seeded_state(S, 3, S, 37),
                  adversarial_state(S + 100, 3, S, 40)):
        got = group_mirror(state)
        for want in (run_ref(state), numpy_oracle(state)):
            for name, g, w in zip(("clocks", "busy", "seen", "end"), got,
                                  want):
                assert same_bits(g, w), (S, name)


def test_group_sizes_cover_every_compiled_instance():
    """``group_size`` is the power of two at or above S, capped at a warp;
    the test depths reach every instance the source compiles."""
    assert [ls.group_size(S) for S in (1, 2, 3, 4, 5, 16, 17, 32, 33, 999)] \
        == [1, 2, 4, 4, 8, 16, 32, 32, 32, 32]
    assert {ls.group_size(S) for S in GROUP_DEPTHS} == {1, 8, 16, 32}
    assert {ls.group_size(S) for S in (2, 3)} == {2, 4}


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
    ls.check_operands(**args)
    assert ls.takes(**args)
    args[field] = bad
    assert not ls.takes(**args)
    with pytest.raises(DeviceError, match=field):
        ls.check_operands(**args)


def test_wrapper_refuses_devices_without_a_kernel():
    t = [torch.from_numpy(a.copy()).to("meta")
         for a in seeded_state(0, 2, 4, 8)]
    with pytest.raises(DeviceError, match="no kernel"):
        ls.step_commit(*t)


# ------------------------------- the card route's host side (CPU, stubs) ---

class StubEntry:
    """A C entry point: calls ``fn``; takes ``argtypes``/``restype`` as a
    ctypes function does."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class StubLibrary:
    """A stand-in for a build of ``lockstep_step.cu``: records each
    launch's unpacked argument block (the commit's in ``calls``, the fused
    step's in ``fused_calls``) and returns ``rc``; ``args_bytes`` and
    ``fused_args_bytes`` are the sizes of its packed arguments, ``group``
    its thread group by S."""

    def __init__(self, rc=0, args_bytes=ls.STEP_ARGS.size,
                 group=ls.group_size, fused_args_bytes=ls.FUSED_ARGS.size):
        self.calls = []
        self.fused_calls = []

        def launch(packed):
            self.calls.append(ls.STEP_ARGS.unpack(packed))
            return rc

        def fused(packed):
            self.fused_calls.append(ls.FUSED_ARGS.unpack(packed))
            return rc

        self.step_commit_launch = StubEntry(launch)
        self.step_commit_args_bytes = StubEntry(lambda: args_bytes)
        self.step_commit_group = StubEntry(group)
        self.step_commit_error_string = StubEntry(lambda rc: b"stub error")
        self.step_fused_launch = StubEntry(fused)
        self.step_fused_args_bytes = StubEntry(lambda: fused_args_bytes)


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors sent down the card route: ``on_card`` says yes, the
    stream is the number 7, and the cached build is a bound stub (loading
    the real one fails the test); the counters start at 0."""
    stub = ls.bind(StubLibrary())
    monkeypatch.setattr(ls, "on_card", lambda kernel, t: True)
    monkeypatch.setattr(ls, "current_stream", lambda t: 7)
    monkeypatch.setattr(ls, "_CACHED", stub)
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail(
        "the cached build was loaded"))
    monkeypatch.setattr(ls, "LAUNCHES", 0)
    monkeypatch.setattr(ls, "SHAPES", type(ls.SHAPES)())
    return stub


def test_card_route_passes_the_packed_argument_block(card_route):
    """One launch, one packed block, field for field: the seven operands'
    and ``end``'s addresses, the stream, then S and B; counted once by
    shape."""
    t = [torch.from_numpy(a.copy()) for a in seeded_state(4, 3, 40, 24)]
    end = ls.step_commit(*t)
    (args,) = card_route.calls
    assert args == (*(x.data_ptr() for x in t), end.data_ptr(), 7, 40, 24)
    assert end.dtype == torch.float64 and tuple(end.shape) == (24,)
    assert ls.LAUNCHES == 1 and dict(ls.SHAPES) == {(3, 40, 24): 1}


def test_card_route_refuses_before_any_launch(card_route):
    """A refused operand raises DeviceError naming it, and nothing is
    launched or counted."""
    t = [torch.from_numpy(a.copy()) for a in seeded_state(5, 2, 8, 16)]
    t[4] = t[4].float()                                  # rt in f32
    with pytest.raises(DeviceError, match="rt must be"):
        ls.step_commit(*t)
    assert not card_route.calls and ls.LAUNCHES == 0 and not ls.SHAPES


def test_refused_launch_raises_and_counts_nothing(card_route, monkeypatch):
    """A launch the C entry refuses is a DeviceError with its message."""
    monkeypatch.setattr(ls, "_CACHED", ls.bind(StubLibrary(rc=1)))
    t = [torch.from_numpy(a.copy()) for a in seeded_state(6, 2, 8, 16)]
    with pytest.raises(DeviceError, match="stub error"):
        ls.step_commit(*t)
    assert ls.LAUNCHES == 0 and not ls.SHAPES


class YieldingCounter(type(ls.SHAPES)):
    """A Counter that gives up the interpreter lock on every read, so an
    increment that no lock holds together can lose another thread's."""

    def __getitem__(self, key):
        count = super().__getitem__(key)
        time.sleep(1e-4)
        return count


def test_counts_add_up_across_threads(card_route, monkeypatch):
    """Eight threads launch through the card route at once, two at each
    of four shapes (as the sweep service's requests do), with ``SHAPES``
    a :class:`YieldingCounter`: ``LAUNCHES`` and ``SHAPES`` count every
    launch, none lost to a race."""
    monkeypatch.setattr(ls, "SHAPES", YieldingCounter())
    per_thread = 300
    states = [[torch.from_numpy(a.copy())
               for a in seeded_state(40 + i, 2, 4 + i % 4, 8)]
              for i in range(8)]
    errors = []
    start = threading.Barrier(len(states))

    def worker(t):
        try:
            start.wait(timeout=30)
            for _ in range(per_thread):
                ls.step_commit(*t)
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in states]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(card_route.calls) == 8 * per_thread
    assert ls.LAUNCHES == 8 * per_thread
    assert dict(ls.SHAPES) == {(2, 4 + i, 8): 2 * per_thread
                               for i in range(4)}


def test_threads_bind_a_library_once():
    """Threads that bind one library at once run its checks once: the
    first binds it under ``build.BIND_LOCK``, the others find it bound."""
    stub = StubLibrary()
    sizes = []
    checked = stub.step_commit_args_bytes.fn
    stub.step_commit_args_bytes = StubEntry(
        lambda: sizes.append(time.sleep(0.001)) or checked())
    threads = [threading.Thread(target=ls.bind, args=(stub,))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(sizes) == 1 and stub._repro_torch_bound


def test_a_library_of_another_argument_layout_is_refused():
    """A build whose packed block differs in size is refused when bound."""
    with pytest.raises(DeviceError, match="step_commit_args_bytes"):
        ls.bind(StubLibrary(args_bytes=ls.STEP_ARGS.size - 8))


def test_a_library_of_other_group_sizes_is_refused():
    """A build whose thread groups differ from ``group_size`` (the
    mirror the reduction is held to) is refused when bound."""
    with pytest.raises(DeviceError, match=r"step_commit_group\(33\)"):
        ls.bind(StubLibrary(group=lambda S: min(ls.group_size(S), 16)
                            if S > 32 else ls.group_size(S)))


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


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 16, 31, 32, 33, 64, 128,
                               200])
def test_kernel_at_every_group_size_on_the_card(S):
    """Every compiled group size (1 to 32 threads a lane), on states whose
    ties and NaNs sit in different threads of a group, bit for bit against
    the plain version; the library's group is ``group_size``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert ls.step_library().step_commit_group(S) == ls.group_size(S)
    for state in (seeded_state(S, 4, S, 16),
                  adversarial_state(S + 7, 3, S, 77)):
        ref = [torch.from_numpy(a.copy()).cuda() for a in state]
        dev = [torch.from_numpy(a.copy()).cuda() for a in state]
        end_ref = ls.step_commit_ref(*ref)
        end_dev = ls.step_commit(*dev)
        torch.cuda.synchronize()
        for g, w in zip(dev[:3] + [end_dev], ref[:3] + [end_ref]):
            assert same_bits(g.cpu().numpy(), w.cpu().numpy()), S


# ------------------------------------------- the fused step (a whole step) ---

def random_scan(seed, P, S, B, rows, *, K=3, NK=4, SC=3, G=3, steps=6,
                nan=True):
    """A slice of the torch scan, every index in range and every path of
    a step taken by some lane: ``(blocks, state, kind_pool, smp_kid)``
    as numpy arrays, ``blocks`` the packed ``(xi, xf, xb)`` of
    ``torchsim._pack``'s layout and ``state`` each ``torchsim._State``
    field.  Own-order and replayed lanes are mixed, as are cohorts; small
    integer costs, clocks, ready times and tie-breaks make ties; rows
    name their conditional parent or themselves; successor lists repeat
    entries and carry the dummy row; some option, pool and placement
    entries are -1; one lane has an all-``inf`` pool, one (with ``nan``)
    a NaN clock and one a NaN heap key; the last two lanes pad, copies
    of lane 0."""
    rng = np.random.default_rng(seed)
    T, dummy, WI = rows + steps, rows - 1, 4 + 2 * K + SC

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape)

    def some(p, shape):
        return rng.random(shape) < p

    xi = np.empty((T, WI, G), dtype=np.int64)
    xi[:, 0] = ints(0, rows, (T, G))
    xi[:, 1] = ints(0, 4, (T, G))
    xi[:, 2] = np.where(some(0.5, (T, G)), -1, ints(0, max(rows - 1, 1),
                                                    (T, G)))
    xi[:, 2] = np.where(some(0.1, (T, G)), xi[:, 0], xi[:, 2])
    xi[:, 3] = ints(0, NK, (T, G))
    xi[:, 4:4 + 2 * K] = np.where(some(0.25, (T, 2 * K, G)), -1,
                                  ints(0, NK, (T, 2 * K, G)))
    succ = ints(0, rows, (T, SC, G))
    succ[:, -1] = np.where(some(0.5, (T, G)), succ[:, 0], succ[:, -1])
    xi[:, 4 + 2 * K:] = np.where(some(0.3, (T, SC, G)), dummy, succ)
    xf = ints(0, 3, (T, 2 * NK, G)).astype(np.float64)
    xb = np.concatenate([some(0.85, (T, 1, G)), some(0.7, (T, 1, G)),
                         some(0.1, (T, 1, G)), some(0.5, (T, NK, G))],
                        axis=1)
    clocks = ints(0, 4, (P, S, B)).astype(np.float64)
    clocks[np.arange(S)[None, :, None] >= ints(1, S + 1, (P, 1, B))] = \
        np.inf
    clocks[P - 1, :, 1 % B] = np.inf
    ready = ints(0, 5, (rows, B)).astype(np.float64)
    npred = ints(-2, 2, (rows, B)).astype(np.int32)
    key = np.where(npred.T == 0, ready.T, np.inf)
    if nan and B > 4:
        clocks[0, 0, 2] = np.nan
        key[3, int(ints(0, rows, ()))] = np.nan
    state = {
        "clocks": clocks, "ready": ready,
        "placement": ints(-1, NK, (rows, B)).astype(np.int32),
        "busy": rng.random((P, B)), "seen": some(0.5, (P, B)),
        "makespan": ints(0, 4, B).astype(np.float64),
        "prev_rt": np.where(some(0.3, B), -np.inf,
                            ints(0, 4, B).astype(np.float64)),
        "prev_tb": ints(-1, 4, B), "div": some(0.1, B), "npred": npred,
        "own": some(0.5, B), "key": key, "t": ints(0, T - steps + 1, B),
        "ran": np.ones(B, dtype=np.int32), "gone": np.full(B, np.inf),
        "cohort": ints(0, G, B)}
    kind_pool = ints(-1, P, (B, NK))
    smp_kid = ints(-1, NK, B)
    for name, a in (*state.items(), ("kind_pool", kind_pool),
                    ("smp_kid", smp_kid)):
        if name in ("key", "kind_pool"):            # lane-first
            a[B - 2:] = a[:1]
        else:
            a[..., B - 2:] = a[..., :1]             # pad lanes copy lane 0
    return (xi, xf, xb), state, kind_pool, smp_kid


def scan_state(state, device):
    """A ``torchsim._State`` holding ``state``'s arrays on ``device``."""
    from repro_torch.core import torchsim
    P, S, B = state["clocks"].shape
    st = torchsim._State(P, S, B, state["ready"].shape[0],
                         torch.device(device))
    for name, a in state.items():
        getattr(st, name).copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return st


#: ``(P, S, B, rows, K, NK, SC, eft)`` of the card's fused-step cases:
#: every group size 1-33 of a pool's slots; rows on both sides of each
#: block-width step and past the widest block's 4,096 keys (a block has
#: the power of two from 32 to 256 threads that gives each thread at most
#: 16 heap keys and each pool ``group_size(S)`` threads, so with P·group
#: at most 32 the width steps at 512, 1024 and 2048 rows:
#: ``fused_threads_for`` of the source); successor lists longer than a
#: block; the benchmark's shapes.
FUSED_CASES = (
    [(3, S, 37, 40, 3, 4, 3, S % 2 == 0)
     for S in (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33)]
    + [(4, 8, 37, rows, 3, 4, 3, rows % 2 == 1)
       for rows in (2, 512, 513, 1024, 1025, 2048, 2049, 4097, 6000)]
    + [(9, 16, 40, 121, 6, 7, 70, eft) for eft in (False, True)]
    + [(4, 8, 256, 3585, 4, 4, 2, False), (5, 16, 64, 121, 4, 6, 5, True)])


def test_fused_cases_cover_every_width():
    """The card's cases reach every group size the fused step compiles,
    and rows on both sides of every block-width step."""
    assert {ls.group_size(c[1]) for c in FUSED_CASES} == \
        {1, 2, 4, 8, 16, 32}
    rows = {c[3] for c in FUSED_CASES if c[0] * ls.group_size(c[1]) <= 32}
    assert all({step, step + 1} <= rows for step in (512, 1024, 2048))
    assert max(rows) > 4096


@pytest.mark.parametrize("case", FUSED_CASES[::4], ids=str)
def test_random_scans_run_in_the_plain_body(case):
    """The card's random slices are slices the plain body takes: every
    index in range, several steps, every field finite or as made."""
    from repro_torch.core import torchsim
    P, S, B, rows, K, NK, SC, eft = case
    blocks, state, kp, sk = random_scan(sum(case), P, S, B, rows, K=K,
                                        NK=NK, SC=SC)
    st = scan_state(state, "cpu")
    torchsim._steps(*(torch.from_numpy(b) for b in blocks), st,
                    torch.from_numpy(kp), torch.from_numpy(sk), eft, K, 6)
    assert st.t.tolist() == (state["t"] + 6).tolist()


def fused_operands(seed=9, P=3, S=5, B=16, rows=20, K=2, NK=3, SC=4):
    """A random slice on CPU tensors: ``(xi, xf, xb, state, kind_pool,
    smp_kid, K)``."""
    blocks, state, kp, sk = random_scan(seed, P, S, B, rows, K=K, NK=NK,
                                        SC=SC)
    return (*(torch.from_numpy(b) for b in blocks), scan_state(state, "cpu"),
            torch.from_numpy(kp), torch.from_numpy(sk), K)


def test_fused_route_passes_the_packed_argument_block(card_route):
    """One fused step, one packed block, field for field: the step
    inputs', pool map's and SMP kinds' addresses, the state's in
    ``FUSED_STATE`` order, the stream, then the sizes and ``eft``;
    counted once at ``(P, S, B)``, and no commit launched."""
    xi, xf, xb, st, kp, sk, K = fused_operands()
    ls.step_fused(xi, xf, xb, st, kp, sk, True, K)
    (args,) = card_route.fused_calls
    T, WI, G = xi.shape
    assert args == (xi.data_ptr(), xf.data_ptr(), xb.data_ptr(),
                    kp.data_ptr(), sk.data_ptr(),
                    *(getattr(st, f).data_ptr() for f in ls.FUSED_STATE),
                    7, 3, 5, 16, 20, T, G, K, 3, WI - 4 - 2 * K, 1)
    assert not card_route.calls
    assert ls.LAUNCHES == 1 and dict(ls.SHAPES) == {(3, 5, 16): 1}


@pytest.mark.parametrize("field,bad", [
    ("xi", lambda t: t.int()),
    ("xf", lambda t: t[:, :-1]),
    ("xb", lambda t: t.transpose(0, 2).contiguous().transpose(0, 2)),
    ("kind_pool", lambda t: t[:-1]),
    ("placement", lambda t: t.long()),
    ("key", lambda t: t.T.contiguous()),
    ("t", lambda t: t[0]),
    ("npred", lambda t: t.to("meta")),
])
def test_fused_route_refuses_before_any_launch(card_route, field, bad):
    """An operand the fused step cannot take — another dtype, shape or
    device, or not contiguous — is a DeviceError naming it; nothing is
    launched or counted."""
    xi, xf, xb, st, kp, sk, K = fused_operands()
    ops = {"xi": xi, "xf": xf, "xb": xb, "kind_pool": kp}
    if field in ops:
        ops[field] = bad(ops[field])
    else:
        setattr(st, field, bad(getattr(st, field)))
    with pytest.raises(DeviceError, match=field):
        ls.step_fused(ops["xi"], ops["xf"], ops["xb"], st, ops["kind_pool"],
                      sk, False, K)
    assert not card_route.fused_calls and ls.LAUNCHES == 0 and not ls.SHAPES


def test_fused_refused_launch_raises_and_counts_nothing(card_route,
                                                        monkeypatch):
    """A fused launch the C entry refuses is a DeviceError with its
    message; nothing is counted."""
    monkeypatch.setattr(ls, "_CACHED", ls.bind(StubLibrary(rc=1)))
    xi, xf, xb, st, kp, sk, K = fused_operands()
    with pytest.raises(DeviceError, match="step_fused.*stub error"):
        ls.step_fused(xi, xf, xb, st, kp, sk, False, K)
    assert ls.LAUNCHES == 0 and not ls.SHAPES


def test_fused_step_refuses_cpu_tensors_off_the_card_route():
    """The fused step has no CPU route: the CPU runs the plain body."""
    xi, xf, xb, st, kp, sk, K = fused_operands()
    with pytest.raises(DeviceError, match="plain body"):
        ls.step_fused(xi, xf, xb, st, kp, sk, False, K)


def test_steps_launch_once_a_step_eager_and_credited_per_replay(card_route):
    """On the card route ``_steps`` launches the fused step once a step
    and nothing else; launches recorded as a graph capture records them
    count at each replay, as ``StepRunner.run`` credits them: the
    ``steps_per_s`` and roofline readers keep one launch a step."""
    from repro_torch.core import torchsim
    xi, xf, xb, st, kp, sk, K = fused_operands()
    torchsim._steps(xi, xf, xb, st, kp, sk, False, K, 5)
    assert len(card_route.fused_calls) == 5 and not card_route.calls
    assert ls.LAUNCHES == 5 and dict(ls.SHAPES) == {(3, 5, 16): 5}
    with ls.recording() as tally:
        torchsim._steps(xi, xf, xb, st, kp, sk, False, K, torchsim.STEPS)
    assert dict(tally) == {(3, 5, 16): torchsim.STEPS}
    assert ls.LAUNCHES == 5
    ls.credit(tally, 3)
    assert ls.LAUNCHES == 5 + 3 * torchsim.STEPS
    assert dict(ls.SHAPES) == {(3, 5, 16): 5 + 3 * torchsim.STEPS}


def test_a_library_of_another_fused_argument_layout_is_refused():
    """A build whose fused step packs another block is refused when
    bound."""
    with pytest.raises(DeviceError, match="step_fused_args_bytes"):
        ls.bind(StubLibrary(fused_args_bytes=ls.FUSED_ARGS.size + 8))


STATE_FIELDS = ("clocks", "ready", "placement", "busy", "seen", "makespan",
                "prev_rt", "prev_tb", "div", "npred", "key", "t")


@pytest.mark.gpu
@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_fused_step_matches_the_plain_body_on_the_card(case):
    """Step after step, every field of the scan's state after the fused
    step on the card equals the plain body's on the CPU, bit for bit, on
    random slices (:func:`random_scan`): replayed and own-order lanes,
    conditional rows and act masks, bad rows, repeated and dummy
    successors, an all-``inf`` pool, NaNs, pad lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import torchsim
    P, S, B, rows, K, NK, SC, eft = case
    blocks, state, kp, sk = random_scan(sum(case) + 1, P, S, B, rows, K=K,
                                        NK=NK, SC=SC)
    cpu, dev = scan_state(state, "cpu"), scan_state(state, "cuda")
    args = {d: ([torch.from_numpy(b).to(d) for b in blocks],
                torch.from_numpy(kp).to(d), torch.from_numpy(sk).to(d))
            for d in ("cpu", "cuda")}
    before = ls.LAUNCHES
    for step in range(6):
        (bc, kc, sc), (bd, kd, sd) = args["cpu"], args["cuda"]
        torchsim._steps(*bc, cpu, kc, sc, eft, K, 1)
        torchsim._steps(*bd, dev, kd, sd, eft, K, 1)
        torch.cuda.synchronize()
        for name in STATE_FIELDS:
            assert same_bits(getattr(dev, name).cpu().numpy(),
                             getattr(cpu, name).numpy()), (step, name)
    assert ls.LAUNCHES == before + 6
