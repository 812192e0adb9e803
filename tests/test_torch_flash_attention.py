"""The port's flash attention against the JAX package's, and on the card.

Inputs are drawn with numpy from a seed, cast to f32 or bf16, and handed
unchanged to both packages.  On the CPU the port's ``ops.attention`` runs
the kernel's plain version behind the JAX package's padding contract; it
is held to ``repro.kernels.ref.attention`` at the shapes of
``tests/test_kernels.py``'s attention tests, with their tolerances (rtol
and atol 2e-4 in f32, 3e-4 for the shape sweep, 3e-2 in bf16, which
keeps 8 bits of mantissa), and to the Pallas kernel itself
(``repro.kernels.ops.attention(..., interpret=True)``) on two small
shapes.  The error contract (``ValueError``, ``NotImplementedError``) is
checked against the JAX package's.

The kernel runs only on a card (``-m gpu``): it is held to its plain
version there at the serve path's shapes, with the same tolerances.
"""
import numpy as np
import pytest
import torch

from repro_torch import DeviceError
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jx():
    """``jax.numpy``, the JAX package's ``ops``/``ref`` and its Pallas
    ``flash_attention``."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref, jfa


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def qkv(seed, bh, bkv, t, s, d, scale=1.0):
    return (normal(seed, bh, t, d, scale=scale),
            normal(seed + 1, bkv, s, d, scale=scale),
            normal(seed + 2, bkv, s, d))


def to_torch(arrays, dtype="float32"):
    return [torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays]


def to_jax(jnp, arrays, dtype="float32"):
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.fixture
def launches():
    """The wrapper's launch counters, cleared for the test."""
    fa.LAUNCHES.clear()
    fa.SHAPES.clear()
    yield fa.LAUNCHES
    fa.LAUNCHES.clear()
    fa.SHAPES.clear()


# ------------------------------------------ against the JAX oracle (CPU) ---

@pytest.mark.parametrize("bh,bkv,t,s,d", [(4, 4, 128, 128, 64),
                                          (8, 2, 128, 128, 64),   # GQA 4:1
                                          (2, 2, 96, 96, 32)])    # padded
def test_attention_causal_matches_jax_oracle(bh, bkv, t, s, d, jx, launches):
    jnp, _, jref, _ = jx
    arrays = qkv(bh * t + d, bh, bkv, t, s, d)
    got = ops.attention(*to_torch(arrays), causal=True, block_q=64,
                        block_k=64)
    want = jref.attention(*to_jax(jnp, arrays), causal=True)
    assert tuple(got.shape) == (bh, t, d)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)
    assert not launches                     # the plain version, no kernel


@pytest.mark.parametrize("window", [32, 64])
def test_attention_sliding_window_matches_jax_oracle(window, jx):
    jnp, _, jref, _ = jx
    arrays = qkv(2, 2, 2, 128, 128, 64)
    got = ops.attention(*to_torch(arrays), causal=True, window=window,
                        block_q=64, block_k=64)
    want = jref.attention(*to_jax(jnp, arrays), causal=True, window=window)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)


def test_attention_softcap_matches_jax_oracle(jx):
    jnp, _, jref, _ = jx
    arrays = qkv(3, 2, 2, 64, 64, 32, scale=3.0)
    got = ops.attention(*to_torch(arrays), causal=True, softcap=30.0,
                        block_q=32, block_k=32)
    want = jref.attention(*to_jax(jnp, arrays), causal=True, softcap=30.0)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("t", [64, 96, 128])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("windowed", [False, True])
def test_attention_shape_sweep_matches_jax_oracle(group, t, d, windowed, jx):
    jnp, _, jref, _ = jx
    arrays = qkv(t * d + group, 2 * group, 2, t, t, d)
    window = 48 if windowed else 0
    got = ops.attention(*to_torch(arrays), causal=True, window=window,
                        block_q=32, block_k=32)
    want = jref.attention(*to_jax(jnp, arrays), causal=True, window=window)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=3e-4,
                               atol=3e-4)


def test_attention_bf16_matches_jax_oracle(jx):
    jnp, _, jref, _ = jx
    arrays = qkv(4, 2, 2, 64, 64, 64)
    got = ops.attention(*to_torch(arrays, "bfloat16"), causal=True,
                        block_q=32, block_k=32)
    want = jref.attention(*to_jax(jnp, arrays, "bfloat16"), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=3e-2,
                               atol=3e-2)


def test_attention_non_causal_unpadded_matches_jax_oracle(jx):
    jnp, _, jref, _ = jx
    arrays = qkv(5, 4, 2, 64, 96, 32)
    got = ops.attention(*to_torch(arrays), causal=False, block_q=32,
                        block_k=32)
    want = jref.attention(*to_jax(jnp, arrays), causal=False)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)


# -------------------------------------- against the Pallas kernel (CPU) ---

@pytest.mark.parametrize("bh,bkv,t,d,window,softcap,block", [
    (2, 2, 150, 32, 0, 0.0, 128),         # T = S = 150 padded to 256
    (8, 2, 64, 16, 24, 20.0, 32),         # GQA 4:1, window and softcap
])
def test_attention_matches_pallas_kernel(bh, bkv, t, d, window, softcap,
                                         block, jx):
    jnp, jops, _, _ = jx
    arrays = qkv(6 + t, bh, bkv, t, t, d, scale=2.0)
    kw = dict(causal=True, window=window, softcap=softcap, block_q=block,
              block_k=block)
    got = ops.attention(*to_torch(arrays), **kw)
    want = jops.attention(*to_jax(jnp, arrays), interpret=True, **kw)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------------- error contract ---

BAD_SHAPES = {
    "head dims differ": ((4, 64, 32), (2, 64, 16), (2, 64, 16)),
    "v unlike k": ((4, 64, 32), (2, 64, 32), (2, 32, 32)),
    "heads not a multiple": ((3, 64, 32), (2, 64, 32), (2, 64, 32)),
    "T not a block multiple": ((4, 48, 32), (2, 64, 32), (2, 64, 32)),
    "S not a block multiple": ((4, 64, 32), (2, 40, 32), (2, 40, 32)),
}


@pytest.mark.parametrize("case", sorted(BAD_SHAPES))
def test_flash_attention_raises_value_error_where_jax_does(case, jx):
    jnp, _, _, jfa = jx
    shapes = BAD_SHAPES[case]
    arrays = [normal(i, *sh) for i, sh in enumerate(shapes)]
    with pytest.raises(ValueError):
        jfa.flash_attention(*to_jax(jnp, arrays), block_q=32, block_k=32,
                            interpret=True)
    with pytest.raises(ValueError):
        fa.flash_attention(*to_torch(arrays), block_q=32, block_k=32)


def test_non_causal_padded_attention_raises_where_jax_does(jx):
    jnp, jops, _, _ = jx
    arrays = qkv(7, 2, 2, 40, 40, 16)
    with pytest.raises(NotImplementedError):
        jops.attention(*to_jax(jnp, arrays), causal=False, block_q=32,
                       block_k=32, interpret=True)
    with pytest.raises(NotImplementedError):
        ops.attention(*to_torch(arrays), causal=False, block_q=32,
                      block_k=32)


def test_default_scale_is_head_dim_to_the_minus_half():
    q, k, v = to_torch(qkv(8, 2, 1, 32, 32, 16))
    got = fa.flash_attention(q, k, v, block_q=32, block_k=32)
    torch.testing.assert_close(
        got, ref.attention(q, k, v, scale=16 ** -0.5), rtol=0, atol=0)
    assert not torch.equal(got, fa.flash_attention(q, k, v, scale=1.0,
                                                   block_q=32, block_k=32))


def test_only_cpu_and_cuda_tensors_have_a_route(launches):
    q, k, v = (torch.empty(sh, device="meta") for sh in
               ((2, 32, 16), (1, 32, 16), (1, 32, 16)))
    with pytest.raises(DeviceError):
        fa.flash_attention(q, k, v, block_q=32, block_k=32)
    assert not launches


# ------------------------------------------------------------ on the card ---

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


#: The chip smoke's shapes: (BH, BKV, T, S, D, dtype, window, softcap, via
#: ops.attention).  The serve path's prefill of qwen3-0.6b, a padded
#: length, gemma2's local layers, an f32 case, a non-causal one, and rows
#: that meet no valid key (T > S under a window).
CARD_CASES = [
    (16, 8, 512, 512, 128, "bfloat16", 0, 0.0, False, True),
    (16, 8, 300, 300, 128, "bfloat16", 0, 0.0, True, True),
    (8, 4, 512, 512, 256, "bfloat16", 256, 50.0, False, True),
    (8, 2, 256, 256, 64, "float32", 0, 0.0, False, True),
    (4, 2, 192, 320, 16, "float32", 0, 0.0, False, False),
    (2, 1, 128, 64, 32, "float32", 16, 0.0, False, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_kernel_matches_plain_version_on_the_card(case, launches):
    card()
    bh, bkv, t, s, d, dtype, window, softcap, padded, causal = case
    q, k, v = (x.cuda() for x in to_torch(qkv(t + d, bh, bkv, t, s, d),
                                          dtype))
    kw = dict(causal=causal, window=window, softcap=softcap)
    if padded:
        got = ops.attention(q, k, v, **kw)
    else:
        got = fa.flash_attention(q, k, v, block_q=64, block_k=64, **kw)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 1
    want = ref.attention(q, k, v, **kw)
    tol = 2e-4 if dtype == "float32" else 3e-2
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(launches):
    card()
    q, k, v = (x.cuda() for x in to_torch(qkv(9, 2, 1, 64, 64, 512)))
    with pytest.raises(DeviceError):                     # wider than 256
        fa.flash_attention(q, k, v, block_q=64, block_k=64)
    q, k, v = (x.cuda() for x in to_torch(qkv(9, 2, 1, 64, 64, 32)))
    with pytest.raises(DeviceError):                     # mixed dtypes
        fa.flash_attention(q, k.bfloat16(), v, block_q=64, block_k=64)
    with pytest.raises(DeviceError):                     # not contiguous
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, block_q=64, block_k=64)
    assert not launches
