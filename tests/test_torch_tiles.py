"""The port's tile kernels against the JAX package's, and on the card.

Inputs are made with numpy from a seed, cast to f32 or bf16 explicitly,
and handed unchanged to both packages.  The JAX side runs
``repro.kernels.ops`` with ``interpret=True`` (the Pallas kernels
evaluated on the CPU, as its own tests run them); the port's wrappers run
their plain versions for CPU tensors.  Tolerances are those of
``tests/test_kernels.py``: f32 matmul rtol 1e-5 with atol 1e-5·k, bf16
2e-2 (bf16 keeps 8 bits of mantissa), syrk and gemm_update 1e-5 / 1e-4,
trsm 2e-4, the blocked Cholesky ``UᵀU`` rtol 2e-3 / atol 2e-1 (entries of
``A`` reach ``2n``), the Fig. 6 product rtol/atol 2e-3 as
``trace_matmul`` checks it.

The kernels themselves run only on a card (``-m gpu``): each is held to
its plain version there at the main paths' shapes.  JAX is imported only
by the tests that run the JAX package, so the card's tests need none.
"""
import numpy as np
import pytest
import torch

from repro_torch import DeviceError
from repro_torch.apps import traditional as trad
from repro_torch.kernels import block_matmul as bm
from repro_torch.kernels import build
from repro_torch.kernels import cholesky_tiles as ct
from repro_torch.kernels import ops, ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jx():
    """``jax.numpy`` and the JAX package's ``repro.kernels.ops``."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jnp, jops


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def both(jnp, x, dtype="float32"):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    return (torch.from_numpy(x).to(DTYPES[dtype]),
            jnp.asarray(x, dtype=getattr(jnp, dtype)))


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def upper_factor(seed, bs):
    """A well-conditioned upper-triangular tile, as ``test_trsm_tile``
    makes it: ``chol(m mᵀ + bs I)ᵀ``."""
    m = normal(seed, bs, bs)
    spd = m @ m.T + bs * np.eye(bs, dtype=np.float32)
    return np.ascontiguousarray(np.linalg.cholesky(spd).T)


@pytest.fixture
def counts():
    """The tile wrappers' launch counters, cleared for the test."""
    bm.LAUNCHES.clear()
    ct.LAUNCHES.clear()
    yield lambda: sum(bm.LAUNCHES.values()) + sum(ct.LAUNCHES.values())
    bm.LAUNCHES.clear()
    ct.LAUNCHES.clear()


# ----------------------------------------------------- against JAX (CPU) ---

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384),
                                   (64, 64, 64), (100, 70, 50)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax(m, k, n, dtype, jx):
    jnp, jops = jx
    a_t, a_j = both(jnp, normal(m * 7 + k, m, k), dtype)
    b_t, b_j = both(jnp, normal(n * 5 + k, k, n), dtype)
    got = ops.matmul(a_t, b_t)
    want = jops.matmul(a_j, b_j, interpret=True)
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (m, n)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol,
                               atol=tol * k)


@pytest.mark.parametrize("mi,ki,ni,blk", [(1, 1, 1, 16), (2, 3, 1, 16),
                                          (3, 2, 2, 16), (1, 3, 3, 32),
                                          (2, 1, 3, 32), (3, 3, 2, 32)])
def test_matmul_block_shape_sweep_matches_jax(mi, ki, ni, blk, jx):
    jnp, jops = jx
    m, k, n = mi * blk, ki * blk, ni * blk
    a_t, a_j = both(jnp, normal(m * 31 + n, m, k))
    b_t, b_j = both(jnp, normal(m + n * 17, k, n))
    got = ops.matmul(a_t, b_t, block_m=blk, block_n=blk, block_k=blk)
    want = jops.matmul(a_j, b_j, block_m=blk, block_n=blk, block_k=blk,
                       interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("bs", [32, 64])
def test_syrk_matches_jax(bs, jx):
    jnp, jops = jx
    a_t, a_j = both(jnp, normal(8, bs, bs))
    c_t, c_j = both(jnp, normal(9, bs, bs))
    got = ops.syrk(a_t, c_t)
    want = jops.syrk(a_j, c_j, interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("bs,panel", [(32, 8), (64, 16), (64, 64)])
def test_trsm_matches_jax(bs, panel, jx):
    jnp, jops = jx
    a_t, a_j = both(jnp, upper_factor(bs, bs))
    b_t, b_j = both(jnp, normal(bs + 1, bs, bs))
    got = ops.trsm(a_t, b_t, panel=panel)
    want = jops.trsm(a_j, b_j, panel=panel, interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)
    # and it solves the system: aᵀ x = b
    np.testing.assert_allclose(as_f32(a_t).T @ as_f32(got), as_f32(b_t),
                               rtol=2e-4, atol=2e-4)


def test_gemm_update_matches_jax(jx):
    jnp, jops = jx
    (a_t, a_j), (b_t, b_j), (c_t, c_j) = (both(jnp, normal(10 + i, 64, 64))
                                          for i in range(3))
    got = ops.gemm_update(a_t, b_t, c_t)
    want = jops.gemm_update(a_j, b_j, c_j, interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-5,
                               atol=1e-4)


def test_gemm_update_takes_rectangular_tiles():
    """``c - bᵀ a`` with ``a [K, N]``, ``b [K, M]``, ``c [M, N]``."""
    a, b, c = normal(1, 24, 40), normal(2, 24, 16), normal(3, 16, 40)
    got = ops.gemm_update(*(torch.from_numpy(x) for x in (a, b, c)))
    np.testing.assert_allclose(got.numpy(), c - b.T @ a, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["contraction", "not_multiple",
                                  "syrk_shapes", "trsm_panel",
                                  "trsm_shapes"])
def test_value_error_contracts_match_jax(case, jx):
    """Both packages refuse the same misuse with ``ValueError``."""
    jnp, _ = jx
    from repro.kernels.block_matmul import block_matmul as jax_block_matmul
    from repro.kernels.cholesky_tiles import syrk_tile as jax_syrk
    from repro.kernels.cholesky_tiles import trsm_tile as jax_trsm
    x = normal(0, 64, 64)
    calls = {
        "contraction": (lambda a, b: bm.block_matmul(a, b[:32], block_m=32,
                                                     block_n=32, block_k=32),
                        lambda a, b: jax_block_matmul(
                            a, b[:32], block_m=32, block_n=32, block_k=32,
                            interpret=True)),
        "not_multiple": (lambda a, b: bm.block_matmul(a, b, block_m=48,
                                                      block_n=64, block_k=64),
                         lambda a, b: jax_block_matmul(
                             a, b, block_m=48, block_n=64, block_k=64,
                             interpret=True)),
        "syrk_shapes": (lambda a, b: ct.syrk_tile(a, b[:32]),
                        lambda a, b: jax_syrk(a, b[:32], interpret=True)),
        "trsm_panel": (lambda a, b: ct.trsm_tile(a, b, panel=24),
                       lambda a, b: jax_trsm(a, b, panel=24, interpret=True)),
        "trsm_shapes": (lambda a, b: ct.trsm_tile(a, b[:32]),
                        lambda a, b: jax_trsm(a, b[:32], interpret=True)),
    }
    port, ref_call = calls[case]
    with pytest.raises(ValueError):
        port(torch.from_numpy(x), torch.from_numpy(x))
    with pytest.raises(ValueError):
        ref_call(jnp.asarray(x), jnp.asarray(x))


def test_gemm_update_refuses_mismatched_tiles():
    x = torch.from_numpy(normal(0, 32, 32))
    with pytest.raises(ValueError, match="gemm_update"):
        ops.gemm_update(x, x[:16], x)


def jax_cholesky_via_tiles(jx, a_full, bs, panel):
    """``tests/test_kernels.py::test_blocked_cholesky_via_tiles``'s loop
    through the JAX package's ``ops``, returning ``U``."""
    jnp, jops = jx
    n = a_full.shape[0]
    nb = n // bs
    blocks = {(j, kk): jnp.asarray(a_full[j*bs:(j+1)*bs, kk*bs:(kk+1)*bs])
              for j in range(nb) for kk in range(nb)}
    for kk in range(nb):
        for j in range(kk):
            blocks[(kk, kk)] = jops.syrk(blocks[(j, kk)], blocks[(kk, kk)],
                                         interpret=True)
        blocks[(kk, kk)] = jnp.linalg.cholesky(blocks[(kk, kk)]).T
        for i in range(kk + 1, nb):
            for j in range(kk):
                blocks[(kk, i)] = jops.gemm_update(
                    blocks[(j, i)], blocks[(j, kk)], blocks[(kk, i)],
                    interpret=True)
        for i in range(kk + 1, nb):
            blocks[(kk, i)] = jops.trsm(blocks[(kk, kk)], blocks[(kk, i)],
                                        panel=panel, interpret=True)
    u = np.zeros((n, n), np.float32)
    for j in range(nb):
        for kk in range(j, nb):
            u[j*bs:(j+1)*bs, kk*bs:(kk+1)*bs] = blocks[(j, kk)]
    return u


def test_cholesky_via_tiles_matches_jax_loop(counts, jx):
    n, bs, panel = 128, 32, 8
    a_full = trad.spd_matrix(n, 0)
    got = trad.cholesky_via_tiles(n, bs, panel, seed=0, device="cpu")
    assert got.device.type == "cpu" and counts() == 0
    got = got.numpy()
    want = jax_cholesky_via_tiles(jx, a_full, bs, panel)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.T @ got, a_full, rtol=2e-3, atol=2e-1)
    assert np.array_equal(got, np.triu(got))


@pytest.mark.parametrize("het", [False, True])
def test_traditional_candidate_on_cpu(het, counts):
    n, bs = 128, 32
    run = trad.traditional_candidate(n, bs, het, device="cpu")
    aa, bb = trad.matmul_blocks(n, bs)
    np.testing.assert_allclose(run.product, np.block(aa) @ np.block(bb),
                               rtol=2e-3, atol=2e-3)
    nb = n // bs
    smp = sum((i + j + kk) % 7 == 0 for i in range(nb) for j in range(nb)
              for kk in range(nb)) if het else 0
    assert (run.fpga_tasks, run.smp_tasks) == (nb ** 3 - smp, smp)
    assert run.build_s == 0.0 and run.tile == 32 and counts() == 0


def test_traditional_blocks_are_fig6s():
    """The seeded blocks are the ones ``_traditional_candidate`` draws."""
    aa, bb = trad.matmul_blocks(128, 64)
    rng = np.random.default_rng(0)
    want = [rng.standard_normal((64, 64), dtype=np.float32)
            for _ in range(8)]
    got = [x for grid in (aa, bb) for row in grid for x in row]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_fig6_candidates_are_the_six():
    names = [trad.candidate_name(*c) for c in trad.FIG6_CANDIDATES]
    assert names == ["1acc64", "2acc64", "1acc64+smp", "2acc64+smp",
                     "1acc128", "1acc128+smp"]


# ------------------------------------------------- wrappers and the build ---

def test_wrappers_run_plain_versions_on_cpu_and_count_nothing(counts):
    a, b, c = (torch.from_numpy(normal(i, 32, 32)) for i in range(3))
    up = torch.from_numpy(upper_factor(3, 32))
    pairs = [(bm.block_matmul(a, b, block_m=32, block_n=32, block_k=32),
              ref.matmul(a, b)),
             (bm.gemm_update_tile(a, b, c), ref.gemm_update(a, b, c)),
             (ct.syrk_tile(a, c), ref.syrk(a, c)),
             (ct.trsm_tile(up, b, panel=8), ref.trsm(up, b))]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert counts() == 0 and not bm.SHAPES and not ct.SHAPES


@pytest.mark.parametrize("wrapper", ["block_matmul", "gemm_update",
                                     "syrk_tile", "trsm_tile"])
def test_wrappers_refuse_devices_without_a_kernel(wrapper):
    x = torch.zeros(16, 16, device="meta")
    call = {"block_matmul": lambda: bm.block_matmul(x, x, block_m=16,
                                                    block_n=16, block_k=16),
            "gemm_update": lambda: bm.gemm_update_tile(x, x, x),
            "syrk_tile": lambda: ct.syrk_tile(x, x),
            "trsm_tile": lambda: ct.trsm_tile(x, x, panel=16)}[wrapper]
    with pytest.raises(DeviceError, match="no kernel"):
        call()


@pytest.mark.parametrize("bad,match", [
    (torch.zeros(8, 8, dtype=torch.float64), "float32 or bfloat16"),
    (torch.zeros(8, 16)[:, ::2], "contiguous"),
    (torch.zeros(64), "2-D"),
    (torch.zeros(8, 8, device="meta"), "is on meta"),
])
def test_operand_checks_refuse_what_the_kernel_cannot_take(bad, match):
    good = torch.zeros(8, 8)
    bm.check_operands("block_matmul", {"a": good, "b": good})
    with pytest.raises(DeviceError, match=match):
        bm.check_operands("block_matmul", {"a": good, "b": bad})


def test_pad_to_matches_jax(jx):
    from repro.kernels.ops import _pad_to as jax_pad_to
    jnp, _ = jx
    x = normal(4, 5, 7)
    for axis, multiple in ((0, 8), (1, 8), (1, 7)):
        got, size = ops._pad_to(torch.from_numpy(x), axis, multiple)
        want, want_size = jax_pad_to(jnp.asarray(x), axis, multiple)
        assert size == want_size
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_build_labels_and_defines():
    assert build.define_flags({"TILE": 128, "A": 1}) == ["-DA=1",
                                                         "-DTILE=128"]
    assert build.label("tiles.cu") == "tiles.cu"
    assert build.label("tiles.cu", {"TILE": 128}) == "tiles.cu[TILE=128]"


def test_fresh_build_failure_raises_and_leaves_no_library(monkeypatch):
    """A fresh build whose compiler cannot run is a DeviceError, and its
    library file is gone afterwards."""
    monkeypatch.setattr(build, "nvcc_path", lambda: "/nonexistent/nvcc")
    before = set(build.FRESH_DIR.glob("*.so")) \
        if build.FRESH_DIR.exists() else set()
    with pytest.raises(DeviceError, match="nvcc failed to run"):
        with build.fresh("tiles.cu", {"TILE": 64}):
            pass
    assert set(build.FRESH_DIR.glob("*.so")) <= before


def test_entry_points_default_to_the_card():
    """Without a card the default device is refused, never replaced."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device runs")
    with pytest.raises(DeviceError, match="no CUDA device"):
        trad.traditional_candidate(128, 32, False)
    with pytest.raises(DeviceError, match="no CUDA device"):
        trad.cholesky_via_tiles(128, 32, 8, seed=0)


# ----------------------------------- the trsm kernel's panel form (CPU) ---

def fma(a, b, c):
    """``a * b + c`` rounded once to f32, as ``fmaf`` does: the product of
    two f32 values is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def trsm_panel_mirror(a, b, panel):
    """``csrc/tiles.cu``'s ``trsm_tile_kernel`` in f32 torch, loop for loop:
    each diagonal panel of ``L = aᵀ`` inverted by substitution on the
    identity (all panels at once; each row scaled by the diagonal's f32
    reciprocal), then per panel ``X_p = inv_p B_p`` (over
    the whole panel, zeros above the diagonal included) and the trailing
    update ``B_tail -= L[tail, p] X_p``, each sum taken in the kernel's
    order with one rounding per FMA."""
    bs = a.shape[0]
    lt = a.float().T.contiguous()
    x = b.float().clone()
    y = torch.zeros_like(x)
    nb = bs // panel
    blocks = torch.stack([lt[p * panel:(p + 1) * panel,
                             p * panel:(p + 1) * panel] for p in range(nb)])
    inv = torch.zeros_like(blocks)                   # [panel block, i, c]
    eye = torch.eye(panel)
    for i in range(panel):
        s = eye[i].expand(nb, panel).clone()
        for j in range(i):
            s = fma(-blocks[:, i, j, None], inv[:, j, :], s)
        inv[:, i, :] = s * (1.0 / blocks[:, i, i, None])
    for p in range(nb):
        p0, tail = p * panel, (p + 1) * panel
        for i in range(panel):
            s = torch.zeros(x.shape[1])
            for j in range(panel):
                s = fma(inv[p, i, j], x[p0 + j], s)
            y[p0 + i] = s
        for j in range(panel):
            x[tail:] = fma(-lt[tail:, p0 + j, None], y[p0 + j][None, :],
                           x[tail:])
    return y.to(b.dtype)


@pytest.mark.parametrize("bs,panel", [(32, 8), (64, 16), (64, 64),
                                      (128, 16)])
def test_trsm_panel_form_fits_the_tolerance(bs, panel, jx):
    """The kernel's algorithm and order of rounding, mirrored on the CPU,
    within TRSM_TOL (2e-4) of the JAX kernel in interpret mode and of the
    plain version, and solving the system."""
    jnp, jops = jx
    a_t, a_j = both(jnp, upper_factor(bs, bs))
    b_t, b_j = both(jnp, normal(bs + 2, bs, 100))
    got = trsm_panel_mirror(a_t, b_t, panel)
    want = jops.trsm(a_j, b_j, panel=panel, interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(got, ref.trsm(a_t, b_t), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(as_f32(a_t).T @ as_f32(got), as_f32(b_t),
                               rtol=2e-4, atol=2e-4)


# ------------------------------- the card route's host side (CPU, stubs) ---

class StubEntry:
    """A C entry point that records its arguments and returns ``rc``;
    takes ``argtypes``/``restype`` as a ctypes function does."""

    def __init__(self, calls, name, rc=0):
        self.calls, self.name, self.rc = calls, name, rc

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.rc


class StubLibrary:
    """A stand-in for a build of ``tiles.cu``: every entry point records
    its calls; ``rc`` is what the launches return, ``fits`` what
    ``tiles_trsm_fits`` returns, ``gemm_bytes`` the size of its packed
    GEMM arguments."""

    def __init__(self, rc=0, fits=1, gemm_bytes=bm.GEMM_ARGS.size):
        self.calls = []
        for name, r in (("tiles_gemm_launch", rc), ("tiles_trsm_launch", rc),
                        ("tiles_gemm_args_bytes", gemm_bytes),
                        ("tiles_trsm_args_bytes", bm.TRSM_ARGS.size),
                        ("tiles_trsm_fits", fits), ("tiles_tile_edge", 64),
                        ("tiles_error_string", b"stub error")):
            setattr(self, name, StubEntry(self.calls, name, r))

    def launches(self):
        """``(entry, unpacked arguments)`` of each launch."""
        packed = {"tiles_gemm_launch": bm.GEMM_ARGS,
                  "tiles_trsm_launch": bm.TRSM_ARGS}
        return [(name, packed[name].unpack(args[0]))
                for name, args in self.calls if name in packed]


@pytest.fixture
def card_route(monkeypatch, counts):
    """CPU tensors sent down the card route: ``on_card`` says yes, the
    stream is the number 7, and the cached build is a stub (loading the
    real one fails the test)."""
    cached = StubLibrary()
    monkeypatch.setattr(bm, "on_card", lambda kernel, t: True)
    monkeypatch.setattr(ct, "on_card", lambda kernel, t: True)
    monkeypatch.setattr(bm, "current_stream", lambda t: 7)
    monkeypatch.setattr(ct, "current_stream", lambda t: 7)
    monkeypatch.setattr(bm, "_CACHED", cached)
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail(
        "the cached build was loaded"))
    return cached


def test_block_matmul_launches_the_library_it_is_given(card_route):
    """``library=`` is bound and launched, never the cached build, and
    the cached build is launched when no library is given."""
    fresh = StubLibrary()
    a = torch.from_numpy(normal(0, 64, 32))
    b = torch.from_numpy(normal(1, 32, 48))
    out = bm.block_matmul(a, b, block_m=64, block_n=48, block_k=32,
                          library=fresh)
    assert fresh._repro_torch_bound and fresh.tiles_gemm_launch.argtypes
    assert not card_route.launches()
    ((name, args),) = fresh.launches()
    assert name == "tiles_gemm_launch"
    assert args == (a.data_ptr(), b.data_ptr(), 0, out.data_ptr(), 7, 64,
                    48, 32, 0, 0, 0, 0)
    assert tuple(out.shape) == (64, 48) and out.dtype == torch.float32
    bm.block_matmul(a, b, block_m=64, block_n=48, block_k=32)
    assert len(card_route.launches()) == 1 and len(fresh.launches()) == 1
    bm.block_matmul(a, b, block_m=64, block_n=48, block_k=32,
                    library=fresh)
    assert len(card_route.launches()) == 1 and len(fresh.launches()) == 2
    assert bm.LAUNCHES["block_matmul"] == 3
    assert bm.SHAPES[("block_matmul", 64, 48, 32, torch.float32)] == 3


def test_card_route_passes_each_wrapper_s_arguments(card_route):
    """gemm_update, syrk_tile and trsm_tile launch the cached build with
    the kernel's argument order: op(A) transposed and C for the first
    two, and the caller's ``panel`` for trsm."""
    a, b = (torch.from_numpy(normal(i, 24, 40 - 24 * i)) for i in range(2))
    c = torch.from_numpy(normal(2, 16, 40))
    sq = torch.from_numpy(normal(3, 32, 32))
    up = torch.from_numpy(upper_factor(4, 32))
    rhs = torch.from_numpy(normal(5, 32, 20)).to(torch.bfloat16)
    outs = [bm.gemm_update_tile(a, b, c), ct.syrk_tile(sq, sq),
            ct.trsm_tile(up.to(torch.bfloat16), rhs, panel=8)]
    (_, gemm), (_, syrk), (_, trsm) = card_route.launches()
    assert gemm == (b.data_ptr(), a.data_ptr(), c.data_ptr(),
                    outs[0].data_ptr(), 7, 16, 40, 24, 0, 0, 1, 1)
    assert syrk == (sq.data_ptr(), sq.data_ptr(), sq.data_ptr(),
                    outs[1].data_ptr(), 7, 32, 32, 32, 0, 0, 1, 1)
    assert trsm[2:] == (outs[2].data_ptr(), 7, 32, 20, 8, 1)
    assert dict(bm.LAUNCHES) == {"gemm_update": 1}
    assert dict(ct.LAUNCHES) == {"syrk_tile": 1, "trsm_tile": 1}


def test_a_library_of_another_argument_layout_is_refused(card_route):
    """A build whose packed arguments differ in size from the wrapper's is
    refused when it is bound, before any launch."""
    x = torch.from_numpy(normal(0, 32, 32))
    other = StubLibrary(gemm_bytes=bm.GEMM_ARGS.size - 8)
    with pytest.raises(DeviceError, match="tiles_gemm_args_bytes"):
        bm.block_matmul(x, x, block_m=32, block_n=32, block_k=32,
                        library=other)
    assert not other.launches() and not bm.LAUNCHES


def refused_calls():
    """``(wrapper, call, message)`` for every operand the kernels refuse,
    each call taking the CPU tensors the card route is given."""
    f32 = lambda seed, *s: torch.from_numpy(normal(seed, *s))   # noqa: E731
    x, y = f32(0, 32, 32), f32(1, 32, 32)
    up = torch.from_numpy(upper_factor(2, 32))
    f64, bf16 = x.double(), y.to(torch.bfloat16)
    strided = f32(3, 32, 64)[:, ::2]
    meta = torch.zeros(32, 32, device="meta")
    blk = dict(block_m=32, block_n=32, block_k=32)
    return [
        ("block_matmul", lambda: bm.block_matmul(x, f64, **blk),
         "float32 or bfloat16"),
        ("block_matmul", lambda: bm.block_matmul(strided, y, **blk),
         "contiguous"),
        ("block_matmul", lambda: bm.block_matmul(x, bf16, **blk),
         "share a dtype"),
        ("block_matmul", lambda: bm.block_matmul(x, meta, **blk),
         "is on meta"),
        ("block_matmul", lambda: bm.block_matmul(
            x, y, out_dtype=torch.float16, **blk), "output must be"),
        ("gemm_update", lambda: bm.gemm_update_tile(f64, f64, x),
         "float32 or bfloat16"),
        ("gemm_update", lambda: bm.gemm_update_tile(x, bf16, y),
         "share a dtype"),
        ("gemm_update", lambda: bm.gemm_update_tile(x, y, strided),
         "contiguous"),
        ("gemm_update", lambda: bm.gemm_update_tile(x, y, meta),
         "is on meta"),
        ("gemm_update", lambda: bm.gemm_update_tile(x, y, f64),
         "float32 or bfloat16"),
        ("syrk_tile", lambda: ct.syrk_tile(f64, x), "float32 or bfloat16"),
        ("syrk_tile", lambda: ct.syrk_tile(x, strided), "contiguous"),
        ("syrk_tile", lambda: ct.syrk_tile(x, meta), "is on meta"),
        ("trsm_tile", lambda: ct.trsm_tile(up, f64, panel=8),
         "float32 or bfloat16"),
        ("trsm_tile", lambda: ct.trsm_tile(up, strided, panel=8),
         "contiguous"),
        ("trsm_tile", lambda: ct.trsm_tile(up, bf16, panel=8),
         "share a dtype"),
        ("trsm_tile", lambda: ct.trsm_tile(up, meta, panel=8), "is on meta"),
        ("trsm_tile", lambda: ct.trsm_tile(up, y[:, 0], panel=8), "2-D"),
    ]


@pytest.mark.parametrize("case", range(len(refused_calls())))
def test_wrappers_refuse_every_operand_the_kernel_refuses(case, card_route):
    """Each refusal is a DeviceError naming the fault, raised before any
    library is touched or any launch counted."""
    wrapper, call, match = refused_calls()[case]
    with pytest.raises(DeviceError, match=match):
        call()
    assert not card_route.calls
    assert not bm.LAUNCHES and not ct.LAUNCHES


@pytest.mark.parametrize("fits,match", [(1, "trsm_tile at bs=32 n=32 "
                                            "panel=8 kernel launch failed: "
                                            "stub error"),
                                        (0, "does not fit")])
def test_refused_trsm_launch_raises(fits, match, card_route, monkeypatch):
    """A launch the C entry refuses (a panel that does not divide bs, a
    tile too large for shared memory) is a DeviceError, never a count."""
    lib = StubLibrary(rc=1, fits=fits)
    monkeypatch.setattr(bm, "_CACHED", lib)
    up = torch.from_numpy(upper_factor(2, 32))
    with pytest.raises(DeviceError, match=match):
        ct.trsm_tile(up, up, panel=8)
    assert not ct.LAUNCHES


def test_too_large_operands_are_refused(card_route, monkeypatch):
    """Sizes at or past ``MAX_DIM`` do not fit the kernel's ``int``
    indices (shown with the limit lowered to 32)."""
    monkeypatch.setattr(bm, "MAX_DIM", 32)
    monkeypatch.setattr(ct, "MAX_DIM", 32)
    x = torch.from_numpy(normal(0, 32, 32))
    for call in (lambda: bm.block_matmul(x, x, block_m=32, block_n=32,
                                         block_k=32),
                 lambda: bm.gemm_update_tile(x, x, x),
                 lambda: ct.syrk_tile(x, x),
                 lambda: ct.trsm_tile(x, x, panel=8)):
        with pytest.raises(DeviceError, match="too large"):
            call()
    assert not card_route.calls


# ------------------------------------------------------------ on the card ---

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 128, 128),
                                   (100, 70, 50)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [64, 128])
def test_block_matmul_kernel_matches_plain_version(m, k, n, dtype, tile):
    card()
    t = DTYPES[dtype]
    a = torch.from_numpy(normal(1, m, k)).to(t).cuda()
    b = torch.from_numpy(normal(2, k, n)).to(t).cuda()
    lib = None if tile == 64 else build.load("tiles.cu", {"TILE": tile})
    assert bm.tiles_library(lib).tiles_tile_edge() == tile
    before = bm.LAUNCHES["block_matmul"]
    got = bm.block_matmul(a, b, block_m=1, block_n=1, block_k=1,
                          library=lib)
    torch.cuda.synchronize()
    assert bm.LAUNCHES["block_matmul"] == before + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), ref.matmul(a, b).float(),
                               rtol=tol, atol=tol * k)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [32, 64])
def test_syrk_and_gemm_update_kernels_match_plain_versions(bs):
    card()
    a, b, c = (torch.from_numpy(normal(i, bs, bs)).cuda() for i in range(3))
    torch.testing.assert_close(ct.syrk_tile(a, c), ref.syrk(a, c),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(bm.gemm_update_tile(a, b, c),
                               ref.gemm_update(a, b, c), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,n", [(64, 64), (32, 8), (128, 100)])
def test_trsm_kernel_matches_plain_version(bs, n):
    card()
    a = torch.from_numpy(upper_factor(bs, bs)).cuda()
    b = torch.from_numpy(normal(bs + 1, bs, n)).cuda()
    torch.testing.assert_close(ct.trsm_tile(a, b, panel=16), ref.trsm(a, b),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cholesky_via_tiles_on_the_card(counts):
    card()
    u = trad.cholesky_via_tiles(256, 64, 16, seed=1)
    assert dict(ct.LAUNCHES) == {"syrk_tile": 6, "trsm_tile": 6}
    assert dict(bm.LAUNCHES) == {"gemm_update": 4}
    u = u.cpu().numpy()
    np.testing.assert_allclose(u.T @ u, trad.spd_matrix(256, 1), rtol=2e-3,
                               atol=2e-1)


@pytest.mark.gpu
def test_traditional_candidate_on_the_card(counts):
    card()
    run = trad.traditional_candidate(256, 64, True)
    aa, bb = trad.matmul_blocks(256, 64)
    np.testing.assert_allclose(run.product, np.block(aa) @ np.block(bb),
                               rtol=2e-3, atol=2e-3)
    assert run.build_s > 0 and bm.LAUNCHES["block_matmul"] == run.fpga_tasks
    assert not list(build.FRESH_DIR.glob("*.so"))


TRSM_PANELS = [(bs, panel) for bs in (32, 64, 128) for panel in (8, 16, 32, 64)
               if panel <= bs]


@pytest.mark.gpu
@pytest.mark.parametrize("bs,panel", TRSM_PANELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trsm_kernel_at_every_panel(bs, panel, dtype):
    """The panel form at panels 8 to 64 and bs 32 to 128, over a ragged
    n = 100 (a last block of 4 columns), against the plain version: f32
    at TRSM_TOL, bf16 at 2e-2 (one bf16 ulp of outputs rounded once from
    f32 values that agree to f32 precision)."""
    card()
    t = DTYPES[dtype]
    a = torch.from_numpy(upper_factor(bs, bs)).to(t).cuda()
    b = torch.from_numpy(normal(bs + 1, bs, 100)).to(t).cuda()
    before = ct.LAUNCHES["trsm_tile"]
    got = ct.trsm_tile(a, b, panel=panel)
    torch.cuda.synchronize()
    assert ct.LAUNCHES["trsm_tile"] == before + 1 and got.dtype == t
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), ref.trsm(a, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_trsm_kernel_refuses_a_panel_that_does_not_divide_bs():
    card()
    a = torch.from_numpy(upper_factor(64, 64)).cuda()
    lib = bm.tiles_library()
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream
    for panel in (24, 0, -16):
        rc = lib.tiles_trsm_launch(bm.TRSM_ARGS.pack(
            a.data_ptr(), a.data_ptr(), out.data_ptr(), stream, 64, 64, panel,
            0))
        assert rc != 0
    with pytest.raises(DeviceError, match="invalid argument"):
        ct.trsm_tile(a, a, panel=-16)


def offset_view(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values in a contiguous tensor whose data starts 4 bytes past
    a 16-byte boundary."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = flat[4 // x.element_size():][:x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,offset", [(64, 33, 64, False),
                                          (48, 64, 40, True),
                                          (100, 70, 50, False),
                                          (16, 8, 24, False),
                                          (32, 1500, 48, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_kernel_at_unaligned_pitches(m, k, n, offset, dtype):
    """Operands whose rows or base are not 16-byte aligned (odd K, bf16
    rows of odd length, a base 4 bytes off) take the element-by-element
    staging of the same kernel, mixed with the 16-byte copies of the
    aligned operand; K = 1,500 is staged in two rounds."""
    card()
    t = DTYPES[dtype]
    a = torch.from_numpy(normal(7, m, k)).to(t).cuda()
    b = torch.from_numpy(normal(8, k, n)).to(t).cuda()
    if offset:
        a = offset_view(a)
    got = bm.block_matmul(a, b, block_m=1, block_n=1, block_k=1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), ref.matmul(a, b).float(),
                               rtol=tol, atol=tol * k)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,m", [(24, 40, 16), (33, 50, 20), (64, 64, 64)])
@pytest.mark.parametrize("dtype,c_dtype", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_gemm_update_kernel_at_rectangular_tiles(k, n, m, dtype, c_dtype):
    """``c - bᵀ a`` with ``a [K, N]``, ``b [K, M]``, ``c [M, N]`` at
    rectangular and odd widths, bf16 inputs into a bf16 or f32 ``c``."""
    card()
    a = torch.from_numpy(normal(1, k, n)).to(DTYPES[dtype]).cuda()
    b = torch.from_numpy(normal(2, k, m)).to(DTYPES[dtype]).cuda()
    c = torch.from_numpy(normal(3, m, n)).to(DTYPES[c_dtype]).cuda()
    got = bm.gemm_update_tile(a, b, c)
    want = ref.gemm_update(a, b, c)
    assert got.dtype == c.dtype
    rtol, atol = (1e-5, 1e-4) if c_dtype == "float32" and dtype == "float32" \
        else (2e-2, 2e-2 * k)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper", ["block_matmul", "gemm_update",
                                     "syrk_tile", "trsm_tile"])
def test_kernels_run_on_the_caller_s_stream(wrapper):
    """Each wrapper's launch follows ``torch.cuda.stream(...)``: its input
    is made on a side stream behind a device spin, so a kernel launched
    on any other stream would read it before it is written."""
    card()
    x = torch.from_numpy(normal(0, 64, 64)).cuda()
    y = torch.from_numpy(normal(1, 64, 64)).cuda()
    up = torch.from_numpy(upper_factor(2, 64)).cuda()
    calls = {
        "block_matmul": (lambda u: bm.block_matmul(u, y, block_m=64,
                                                   block_n=64, block_k=64),
                         lambda u: ref.matmul(u, y)),
        "gemm_update": (lambda u: bm.gemm_update_tile(u, y, x),
                        lambda u: ref.gemm_update(u, y, x)),
        "syrk_tile": (lambda u: ct.syrk_tile(u, x),
                      lambda u: ref.syrk(u, x)),
        "trsm_tile": (lambda u: ct.trsm_tile(up, u, panel=16),
                      lambda u: ref.trsm(up, u)),
    }
    run, plain = calls[wrapper]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 24)
        u = x * 1.0
        got = run(u)
    side.synchronize()
    torch.testing.assert_close(got, plain(x), rtol=2e-4, atol=2e-4)
