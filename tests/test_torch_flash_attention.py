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

The bf16 ``wgmma`` kernel's arithmetic (64-row query tiles, 64- or
128-key tiles, f32 online softmax, P rounded to bf16 before the PV
product, l summed from the f32 P, the finite ``NEG_INF`` and the masked
tile skips) is emulated here in numpy and held to the JAX oracle at the
bf16 tolerance before any card run; :func:`fa.kernel_for`'s routing rule
is checked on the CPU too.

The kernels run only on a card (``-m gpu``): they are held to their
plain version there at the serve path's shapes, with the same
tolerances, and each call's kernel is the one the routing rule names.
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
    fa.VARIANTS.clear()
    yield fa.LAUNCHES
    fa.LAUNCHES.clear()
    fa.SHAPES.clear()
    fa.VARIANTS.clear()


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


# ------------------------- the wgmma kernel's arithmetic, emulated (CPU) ---

NEG_INF = -1e30
LOG2E = np.float32(1.4426950408889634)


def bf16(x):
    """``x`` rounded to bf16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def wgmma_emulation(q, k, v, *, causal, window, softcap, scale,
                    block_k=64):
    """``flash_attention_wgmma.cu``'s arithmetic in numpy on bf16-valued
    f32 inputs: per head and 64-row query tile, the key tiles of
    ``[k_begin, k_end)`` in steps of ``block_k``; scores in f32 and the
    softmax in the log2 domain; keys outside ``[k_begin, k_end)`` no term,
    masked keys the finite ``NEG_INF`` (a tile the kernel deems seen in
    full, and so leaves unmasked, must have no such key); ``l`` from the f32 P, the PV
    product on P rounded to bf16; ``l == 0`` divides by 1; the output
    rounded once to bf16."""
    bh, t, d = q.shape
    bkv, s, _ = k.shape
    group = bh // bkv
    out = np.zeros_like(q)
    for h in range(bh):
        kh, vh = k[h // group], v[h // group]
        for q0 in range(0, t, 64):
            n = min(64, t - q0)
            rows = np.arange(q0, q0 + 64)[:, None]
            q_last = q0 + n - 1
            k_end = min(s, q_last + 1) if causal else s
            k_begin = (max(0, q0 - window + 1)
                       if window > 0 and q_last < s else 0)
            qt = np.zeros((64, d), np.float32)
            qt[:n] = q[h, q0:q0 + n]
            m = np.full(64, NEG_INF, np.float32)
            l = np.zeros(64, np.float32)
            acc = np.zeros((64, d), np.float32)
            for k0 in range(k_begin, k_end, block_k):
                kp = np.arange(k0, k0 + block_k)
                kt = np.zeros((block_k, d), np.float32)
                vt = np.zeros((block_k, d), np.float32)
                inside = kp < s                 # TMA reads zeros past S
                kt[inside], vt[inside] = kh[kp[inside]], vh[kp[inside]]
                sc = qt @ kt.T
                if softcap > 0:
                    x = softcap * np.tanh(sc * np.float32(scale) / softcap) \
                        * LOG2E
                else:
                    x = sc * np.float32(scale * LOG2E)
                valid = np.ones((64, block_k), bool)
                if causal:
                    valid &= kp[None] <= rows
                if window > 0:
                    valid &= kp[None] > rows - window
                visited = (kp >= k_begin) & (kp < k_end)
                plain = (k0 >= k_begin and k0 + block_k <= k_end
                         and (not causal or k0 + block_k - 1 <= q0)
                         and (window <= 0 or k0 > q0 + 63 - window))
                if plain:               # the kernel skips the mask tests
                    assert valid.all() and visited.all()
                x = np.where(valid, x, np.float32(NEG_INF))
                x = np.where(visited[None], x, -np.inf).astype(np.float32)
                m_new = np.maximum(m, x.max(1))
                corr = np.exp2(m - m_new)
                p = np.exp2(x - m_new[:, None])
                l = l * corr + p.sum(1)
                acc = acc * corr[:, None] + bf16(p) @ vt
                m = m_new
            denom = np.where(l == 0, np.float32(1), l)
            out[h, q0:q0 + n] = (acc / denom[:, None])[:n]
    return bf16(out)


#: (BH, BKV, T, S, D, causal, window, softcap): GQA groups 1, 2 and 4, a
#: window that is no tile multiple, softcap 50, rows with no valid key
#: (T > S under a window), a ragged S, non-causal, D 64 and 128.
EMULATION_CASES = [
    (2, 2, 128, 128, 64, True, 0, 0.0),
    (4, 2, 192, 192, 64, True, 0, 0.0),
    (4, 1, 128, 128, 128, True, 0, 0.0),
    (2, 1, 256, 256, 64, True, 100, 0.0),
    (2, 2, 192, 192, 128, True, 72, 50.0),
    (2, 1, 256, 96, 64, True, 40, 0.0),
    (2, 1, 128, 100, 64, False, 0, 0.0),
]


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("case", EMULATION_CASES, ids=str)
def test_wgmma_precision_contract_matches_jax_oracle(case, block_k, jx):
    jnp, _, jref, _ = jx
    bh, bkv, t, s, d, causal, window, softcap = case
    arrays = [bf16(a) for a in qkv(t + s + d, bh, bkv, t, s, d,
                                   scale=2.0)]
    got = wgmma_emulation(*arrays, causal=causal, window=window,
                          softcap=softcap, scale=d ** -0.5,
                          block_k=block_k)
    want = jref.attention(*to_jax(jnp, arrays, "bfloat16"), causal=causal,
                          window=window, softcap=softcap)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, as_f32(want), rtol=3e-2, atol=3e-2)


def test_wgmma_emulation_rounds_p_and_differs_from_f32_products():
    """The emulation is not the plain version by another name: rounding P
    to bf16 moves the output, by far less than the bf16 tolerance."""
    arrays = [bf16(a) for a in qkv(11, 2, 1, 128, 128, 64, scale=2.0)]
    got = wgmma_emulation(*arrays, causal=True, window=0, softcap=0.0,
                          scale=64 ** -0.5)
    want = ref.attention(*(torch.from_numpy(a) for a in arrays),
                         causal=True).numpy()
    err = np.abs(got - want).max()
    assert 0 < err < 3e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tma_alignment_is_refused_only_for_the_wgmma_kernel(dtype):
    """A contiguous view 2 or 4 bytes off a 16-byte boundary: the wgmma
    kernel's TMA loads cannot take it (``DeviceError`` before any launch),
    the FMA kernel can."""
    q, k, v = to_torch(qkv(12, 2, 1, 64, 64, 128), dtype)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    fa.check_operands(q, k, v)                       # aligned: taken
    if fa.kernel_for(q.dtype, 128) == "wgmma":
        with pytest.raises(DeviceError, match="16-byte"):
            fa.check_operands(shifted, k, v)
    else:
        fa.check_operands(shifted, k, v)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 96, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 256, "fma"),
])
def test_kernel_for_routes_by_dtype_and_head_width(dtype, d, want):
    assert fa.kernel_for(dtype, d) == want


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
#: ops.attention, causal).  The serve path's prefill of qwen3-0.6b, a
#: padded length, gemma2's local layers, an f32 case, a non-causal one,
#: rows that meet no valid key (T > S under a window), for the wgmma
#: kernel D 64 (causal, GQA 4:1; windowed and ragged; non-causal) and
#: T = S = 1024, and for the FMA kernel's bf16 build D 96 and D 32.
CARD_CASES = [
    (8, 4, 512, 512, 96, "bfloat16", 0, 0.0, False, True),
    (4, 2, 300, 300, 32, "bfloat16", 64, 50.0, True, True),
    (16, 4, 512, 512, 64, "bfloat16", 0, 0.0, False, True),
    (8, 8, 300, 300, 64, "bfloat16", 100, 0.0, True, True),
    (4, 2, 256, 256, 64, "bfloat16", 0, 0.0, False, False),
    (2, 1, 256, 96, 64, "bfloat16", 40, 0.0, True, True),
    (16, 8, 1024, 1024, 128, "bfloat16", 0, 0.0, False, True),
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
    assert fa.VARIANTS == {fa.kernel_for(q.dtype, d): 1}
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
    q, k, v = (x.cuda() for x in to_torch(qkv(9, 2, 1, 64, 64, 128),
                                          "bfloat16"))
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    shifted = flat[1:].view(q.shape)                     # 2 bytes off 16
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(DeviceError):                     # TMA: misaligned
        fa.flash_attention(shifted, k, v, block_q=64, block_k=64)
    assert not launches
    assert not fa.VARIANTS
