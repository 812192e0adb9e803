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
