"""The port's linear attention against the JAX package's, and on the card.

Inputs are drawn with numpy from a seed, as ``tests/test_kernels.py``
draws them (r standard normal, k and v at 0.5, u at 0.3, RWKV6's decay
``exp(-exp(z))``), and handed unchanged to both packages.  On the CPU the
port's plain versions — ``ref.linear_attention(_state)`` (the exact
per-step recurrence), ``ops.linear_attn`` (the wrapper behind the JAX
package's padding contract, which runs the recurrence for CPU tensors)
and ``linear_blocks.linear_attention_chunked`` (the closed form the
models' ``"chunked"`` route runs) — are held to
``repro.kernels.ref.linear_attention(_state)`` and to the Pallas kernel
itself (``repro.kernels.ops.linear_attn(..., interpret=True)``) with
``tests/test_kernels.py``'s tolerances: 2e-4 in f32, 1e-3 under strong
decay, 5e-4 over its shape sweep.  RWKV6's mixed types (bf16 r/k/v and
bonus, f32 decay) are held to the JAX package's chunked form at 1e-2 on
the bf16 output (above 2**-7, one bf16 ulp relative) and 2e-4 on the f32
state.  The ``ValueError`` contract is checked beside the JAX kernel's.

The kernel runs only on a card (``-m gpu``): it is held to its plain
version there at ``chip_smoke.py``'s five cases, with the same
tolerances, and refuses what it cannot take with ``DeviceError``.
"""
import numpy as np
import pytest
import torch

from repro_torch import DeviceError
from repro_torch.kernels import linear_attn as la
from repro_torch.kernels import ops, ref
from repro_torch.models import linear_blocks as LB

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jx():
    """``jax.numpy``, the JAX package's ``ops``/``ref``, its Pallas
    ``linear_attn`` module and its ``linear_blocks``."""
    import jax.numpy as jnp
    from repro.kernels import linear_attn as jla
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import linear_blocks as JLB
    return jnp, jops, jref, jla, JLB


def lin_inputs(seed, bh, h, t, dk, dv, *, decay_strength=1.0):
    """``(r, k, v, w, u)`` as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, t, dk))
    k = rng.standard_normal((bh, t, dk)) * 0.5
    v = rng.standard_normal((bh, t, dv)) * 0.5
    w = np.exp(-np.exp(rng.standard_normal((bh, t, dk)) * decay_strength))
    u = rng.standard_normal((h, dk)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w, u)]


def scalar_decay_inputs(seed, bh, t, dk, dv):
    """Mamba2's form: one decay per step broadcast over dk, no bonus."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, t, dk)) * 0.5
    k = rng.standard_normal((bh, t, dk)) * 0.5
    v = rng.standard_normal((bh, t, dv)) * 0.5
    a = 1 / (1 + np.exp(-rng.standard_normal((bh, t, 1))))
    w = np.broadcast_to(a, (bh, t, dk))
    u = np.zeros((1, dk))
    return [np.ascontiguousarray(x, dtype=np.float32)
            for x in (r, k, v, w, u)]


def to_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def to_jax(jnp, arrays):
    return [jnp.asarray(a) for a in arrays]


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.fixture
def launches():
    """The wrapper's launch counters, cleared for the test."""
    la.LAUNCHES.clear()
    la.SHAPES.clear()
    yield la.LAUNCHES
    la.LAUNCHES.clear()
    la.SHAPES.clear()


def port_version(impl, r, k, v, w, u, chunk, heads):
    """``(out (BH, T, dv), state (BH, dk, dv))`` of one of the port's plain
    routes."""
    if impl == "ref":
        return ref.linear_attention_state(r, k, v, w, u)
    if impl == "ops":
        return ops.linear_attn_state(r, k, v, w, u, chunk=chunk)
    bh, t, dk = r.shape
    b = bh // heads
    out, state = LB.linear_attention_chunked(
        *(x.reshape(b, heads, t, x.shape[-1]) for x in (r, k, v, w)), u,
        chunk=chunk)
    return out.reshape(bh, t, -1), state.reshape(bh, dk, -1)


# ------------------------------------------ against the JAX oracle (CPU) ---

@pytest.mark.parametrize("t,chunk", [(64, 16), (96, 32), (70, 32)])
@pytest.mark.parametrize("impl", ["ref", "ops", "chunked"])
def test_port_versions_match_jax_oracle(t, chunk, impl, jx, launches):
    jnp, _, jref, _, _ = jx
    arrays = lin_inputs(5 + t, 4, 2, t, 32, 32)
    got, got_state = port_version(impl, *to_torch(arrays), chunk, 2)
    want, want_state = jref.linear_attention_state(*to_jax(jnp, arrays))
    assert tuple(got.shape) == (4, t, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(as_f32(got_state), as_f32(want_state),
                               rtol=2e-4, atol=2e-4)
    assert not launches                     # the plain version, no kernel


@pytest.mark.parametrize("t", [16, 48, 80])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dk", [8, 16])
def test_ops_shape_sweep_matches_jax_oracle(t, chunk, dk, jx):
    jnp, _, jref, _, _ = jx
    arrays = lin_inputs(t + dk, 2, 1, t, dk, dk)
    got = ops.linear_attn(*to_torch(arrays), chunk=chunk)
    want = jref.linear_attention(*to_jax(jnp, arrays))
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=5e-4,
                               atol=5e-4)


def test_short_sequence_shrinks_the_chunk_and_pads(jx):
    """T = 5 runs one chunk of 8 (``min(chunk, max(8, T))``) with three
    padded steps that leave the state as it was."""
    jnp, _, jref, _, _ = jx
    arrays = lin_inputs(9, 2, 2, 5, 16, 8)
    got, state = ops.linear_attn_state(*to_torch(arrays), chunk=64)
    want, want_state = jref.linear_attention_state(*to_jax(jnp, arrays))
    assert tuple(got.shape) == (2, 5, 8)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(as_f32(state), as_f32(want_state), rtol=2e-4,
                               atol=2e-4)


# -------------------------------------- against the Pallas kernel (CPU) ---

@pytest.mark.parametrize("t,chunk", [(64, 16), (96, 32), (70, 32)])
def test_ops_matches_pallas_kernel(t, chunk, jx):
    jnp, jops, _, _, _ = jx
    arrays = lin_inputs(5, 4, 2, t, 32, 32)
    got = ops.linear_attn(*to_torch(arrays), chunk=chunk)
    want = jops.linear_attn(*to_jax(jnp, arrays), chunk=chunk,
                            interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)


def test_strong_decay_matches_pallas_kernel(jx):
    """w down to 1e-6 per step: no overflow, tolerance 1e-3."""
    jnp, jops, jref, _, _ = jx
    arrays = lin_inputs(6, 2, 2, 64, 16, 16, decay_strength=3.0)
    arrays[3] = np.minimum(arrays[3], 1e-6)
    got = ops.linear_attn(*to_torch(arrays), chunk=32)
    chunked, _ = port_version("chunked", *to_torch(arrays), 32, 2)
    want = jops.linear_attn(*to_jax(jnp, arrays), chunk=32, interpret=True)
    assert np.isfinite(as_f32(got)).all()
    for port in (got, chunked):
        np.testing.assert_allclose(as_f32(port), as_f32(want), rtol=1e-3,
                                   atol=1e-3)
    np.testing.assert_allclose(
        as_f32(got), as_f32(jref.linear_attention(*to_jax(jnp, arrays))),
        rtol=1e-3, atol=1e-3)


def test_scalar_decay_mamba_mode_matches_pallas_kernel(jx):
    jnp, jops, _, _, _ = jx
    arrays = scalar_decay_inputs(7, 2, 64, 16, 32)
    got = ops.linear_attn(*to_torch(arrays), chunk=16)
    chunked, _ = port_version("chunked", *to_torch(arrays), 16, 1)
    want = jops.linear_attn(*to_jax(jnp, arrays), chunk=16, interpret=True)
    for port in (got, chunked):
        np.testing.assert_allclose(as_f32(port), as_f32(want), rtol=2e-4,
                                   atol=2e-4)


# ------------------------------------------ RWKV6's mixed types (CPU) ---

@pytest.mark.parametrize("route", ["kernel", "chunked"])
def test_bf16_rkv_f32_decay_matches_jax_chunked_form(route, jx):
    """bf16 r, k, v and bonus with an f32 decay, as ``rwkv6_block`` feeds
    them: the output is bf16 within 1e-2, the state f32 within 2e-4."""
    jnp, _, _, _, JLB = jx
    b, h, t, dk = 2, 4, 40, 16
    r, k, v, w, u = lin_inputs(8, b * h, h, t, dk, dk)
    shaped = [x.reshape(b, h, t, dk) for x in (r, k, v, w)]
    bf16 = [torch.from_numpy(x).to(torch.bfloat16) for x in shaped[:3]]
    ub = torch.from_numpy(u).to(torch.bfloat16)
    attend = (LB.linear_attention_kernel if route == "kernel"
              else LB.linear_attention_chunked)
    got, state = attend(*bf16, torch.from_numpy(shaped[3]), ub, chunk=16)
    jb = [jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
          for x in bf16 + [ub]]
    want, want_state = JLB.linear_attention_chunked(
        jb[0], jb[1], jb[2], jnp.asarray(shaped[3]), jb[3], chunk=16)
    assert got.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(as_f32(state), as_f32(want_state), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------------- error contract ---

BAD_SHAPES = {    # (BH, T, dk, dv, H, chunk)
    "T not a chunk multiple": (4, 40, 16, 16, 2, 16),
    "BH not a multiple of H": (6, 32, 16, 16, 4, 16),
}


@pytest.mark.parametrize("case", sorted(BAD_SHAPES))
def test_linear_attention_raises_value_error_where_jax_does(case, jx):
    jnp, _, _, jla, _ = jx
    bh, t, dk, dv, h, chunk = BAD_SHAPES[case]
    arrays = lin_inputs(10, bh, h, t, dk, dv)
    with pytest.raises(ValueError):
        jla.linear_attention(*to_jax(jnp, arrays), chunk=chunk,
                             interpret=True)
    with pytest.raises(ValueError):
        la.linear_attention(*to_torch(arrays), chunk=chunk)


def test_contract_entry_returns_the_output_alone():
    arrays = to_torch(lin_inputs(11, 2, 1, 32, 8, 8))
    out = la.linear_attention(*arrays, chunk=16)
    want, _ = ref.linear_attention_state(*arrays)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert torch.equal(ops.linear_attn(*arrays, chunk=16), out)


def test_only_cpu_and_cuda_tensors_have_a_route(launches):
    r, k, w = (torch.empty((2, 32, 8), device="meta") for _ in range(3))
    v = torch.empty((2, 32, 8), device="meta")
    u = torch.empty((1, 8), device="meta")
    with pytest.raises(DeviceError):
        la.linear_attention(r, k, v, w, u, chunk=16)
    assert not launches


# ------------------------------------------------------------ on the card ---

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


#: ``chip_smoke.py``'s cases: (label, (BH, T, dk, dv), dtype of r/k/v/u,
#: decay, via ops.linear_attn).  rwkv6-1.6b's prefill of a 512-token
#: prompt, a padded length, strong decay, Mamba2's scalar decay with no
#: bonus, and f32 throughout; then a small odd chunk with a ragged dv.
CARD_CASES = [
    ("path", (32, 512, 64, 64), "bfloat16", "rwkv", False, 64),
    ("padded", (32, 300, 64, 64), "bfloat16", "rwkv", True, 64),
    ("strong_decay", (32, 512, 64, 64), "float32", "strong", False, 64),
    ("scalar_decay_u0", (32, 512, 64, 64), "float32", "scalar", False, 64),
    ("f32", (32, 512, 64, 64), "float32", "rwkv", False, 64),
    ("odd_chunk", (3, 42, 16, 20), "float32", "rwkv", False, 7),
]


def card_inputs(seed, shape, dtype, decay):
    bh, t, dk, dv = shape
    if decay == "scalar":
        arrays = scalar_decay_inputs(seed, bh, t, dk, dv)
    else:
        arrays = lin_inputs(seed, bh, bh, t, dk, dv,
                            decay_strength=3.0 if decay == "strong" else 1.0)
        if decay == "strong":
            arrays[3] = np.minimum(arrays[3], 1e-6)
    r, k, v, w, u = (torch.from_numpy(a).cuda() for a in arrays)
    cast = DTYPES[dtype]
    return r.to(cast), k.to(cast), v.to(cast), w, u.to(cast)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_kernel_matches_plain_version_on_the_card(case, launches):
    card()
    label, shape, dtype, decay, padded, chunk = case
    r, k, v, w, u = card_inputs(20 + len(label), shape, dtype, decay)
    if padded:
        got, state = ops.linear_attn_state(r, k, v, w, u, chunk=chunk)
    else:
        got, state = la.linear_attention_state(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert launches["linear_attn"] == 1
    want, want_state = ref.linear_attention_state(r, k, v, w, u)
    tol = 1e-2 if dtype == "bfloat16" else (1e-3 if decay == "strong"
                                             else 2e-4)
    stol = 1e-3 if decay == "strong" else 2e-4
    assert got.dtype == r.dtype and got.shape == v.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=stol, atol=stol)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(launches):
    card()
    r, k, v, w, u = card_inputs(9, (4, 64, 16, 16), "float32", "rwkv")
    with pytest.raises(DeviceError):                     # mixed r/k dtypes
        la.linear_attention(r, k.bfloat16(), v, w, u, chunk=16)
    with pytest.raises(DeviceError):                     # not contiguous
        la.linear_attention(r.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, w, u, chunk=16)
    long = card_inputs(9, (4, 128, 16, 16), "float32", "rwkv")
    with pytest.raises(DeviceError):                     # chunk above 64
        la.linear_attention(*long, chunk=128)
    with pytest.raises(DeviceError):                     # half precision
        la.linear_attention(r.half(), k.half(), v.half(), w, u, chunk=16)
    wide = card_inputs(9, (4, 64, 192, 16), "float32", "rwkv")
    with pytest.raises(DeviceError):                     # dk above 128
        la.linear_attention(*wide, chunk=16)
    with pytest.raises(DeviceError):                     # u off the card
        la.linear_attention(r, k, v, w, u.cpu(), chunk=16)
    assert not launches
