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
decay (and under zamba2's decay spectrum, where some steps underflow to
w = 0), 5e-4 over its shape sweep.  RWKV6's mixed types (bf16 r/k/v and
bonus, f32 decay) are held to the JAX package's chunked form at 1e-2 on
the bf16 output (above 2**-7, one bf16 ulp relative) and 2e-4 on the f32
state.  The ``ValueError`` contract is checked beside the JAX kernel's.

The sub-chunked kernel's arithmetic (``csrc/linear_attn_tc.cu``: the
decay factored at sub-chunks of 16, the diagonal blocks pairwise, and on
its bf16 route each decayed operand and incoming state split into bf16
hi + lo, the scores into hi + mid + lo, for the tensor cores) is
mirrored here in plain PyTorch and
held to the JAX package's oracle and Pallas kernel at the tolerances
above, under RWKV6's, strong and scalar decay; one bf16 rounding in its
place misses them, which is why the kernel splits.  ``kernel_for``'s
routing rule and the card route's packed arguments (through a stub
library) are checked on the CPU too, and a Mamba2 layer's prefill on
that route: one f32 launch, and a refused launch raises with no
fallback to the chunked form.

The kernels run only on a card (``-m gpu``): they are held to their plain
version there at ``chip_smoke.py``'s cases and at chunks 16 and 32, with
the same tolerances, each call on the kernel ``kernel_for`` names, and
refuse what they cannot take with ``DeviceError``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import DeviceError
from repro_torch.kernels import build
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


def zamba2_decay_inputs(seed, bh, heads, t, dk, dv, *, spread=1.0):
    """Mamba2's form with zamba2's decay spectrum: row ``bh`` (head ``bh %
    heads``) decays by ``exp(-softplus(spread·z) · linspace(1, 16,
    heads)[head])`` a step, broadcast over dk (``a_log = log(linspace(1,
    16, h))``, ``dt_bias = 0``, ``dt`` standard normal); no bonus."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, t, dk)) * 0.5
    k = rng.standard_normal((bh, t, dk)) * 0.5
    v = rng.standard_normal((bh, t, dv)) * 0.5
    rate = np.linspace(1.0, 16.0, heads)[np.arange(bh) % heads]
    dt = np.logaddexp(0.0, spread * rng.standard_normal((bh, t, 1)))
    w = np.broadcast_to(np.exp(-dt * rate[:, None, None]), (bh, t, dk))
    u = np.zeros((heads, dk))
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
    for counter in (la.LAUNCHES, la.SHAPES, la.VARIANTS):
        counter.clear()
    yield la.LAUNCHES
    for counter in (la.LAUNCHES, la.SHAPES, la.VARIANTS):
        counter.clear()


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


def test_zamba2_decay_spectrum_matches_pallas_kernel(jx):
    """zamba2's per-head decays, the last heads losing e^-16 and more a
    step and some steps underflowing to w = 0 in f32 (the kernels clamp
    at 1e-30 as the Pallas kernel does): the port's plain routes against
    the Pallas kernel in interpret mode at the strong-decay tolerance."""
    jnp, jops, jref, _, _ = jx
    arrays = zamba2_decay_inputs(8, 8, 4, 64, 16, 32, spread=3.0)
    assert (arrays[3] == 0).any() and (arrays[3] > 0.5).any()
    got = ops.linear_attn(*to_torch(arrays), chunk=16)
    chunked, _ = port_version("chunked", *to_torch(arrays), 16, 4)
    want = jops.linear_attn(*to_jax(jnp, arrays), chunk=16, interpret=True)
    assert np.isfinite(as_f32(got)).all()
    for port in (got, chunked):
        np.testing.assert_allclose(as_f32(port), as_f32(want), rtol=1e-3,
                                   atol=1e-3)
    np.testing.assert_allclose(
        as_f32(got), as_f32(jref.linear_attention(*to_jax(jnp, arrays))),
        rtol=1e-3, atol=1e-3)


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


# ------------------------------- the sub-chunked kernel's arithmetic ---

def _rounded(x, rounding):
    """``x`` as the kernel's products see it: f32 (``"f32"``), rounded to
    bf16 once (``"bf16"``), or split into two or three bf16 terms
    (``"split"``: hi + lo; ``"split3"``: hi + mid + lo)."""
    if rounding == "f32":
        return x
    hi = x.to(torch.bfloat16).float()
    if rounding == "bf16":
        return hi
    mid = (x - hi).to(torch.bfloat16).float()
    if rounding == "split":
        return hi + mid
    return hi + mid + (x - hi - mid).to(torch.bfloat16).float()


#: The kernel's roundings by route: (the decayed operands' and the
#: state's, the scores' in scores.v).
ROUTE_ROUNDING = {"float32": ("f32", "f32"), "bfloat16": ("split", "split3")}


def subchunk_mirror(r, k, v, w, u, chunk, rounding="f32", pv_rounding=None,
                    sub=16):
    """``linear_attn_tc.cu``'s arithmetic in plain PyTorch, in f32:
    running sums of log2 w per chunk; the diagonal ``sub x sub`` blocks of
    the scores pairwise within each half, their second half's rows against
    their first half's columns factored at the first half's last step,
    with the bonus; each earlier block of a band the
    product ``(R^ 2^(P_i - E_j)) K~_jᵀ``, where ``R^ = r 2^(a_exc - P_i)``
    and ``K~ = k 2^(E_j - a_inc)`` (``P_i`` the running sum before band i,
    ``E_j`` at band j's last step: every exponent <= 0); then per chunk
    ``o = (R^ 2^P_i) S_c + scores v`` and ``S_{c+1} = 2^a_end S_c + (k
    2^(a_end - a_inc))ᵀ v``.  ``rounding`` applies to both operands of
    every product but ``v``'s (exact in bf16 on the bf16 route), and
    ``pv_rounding`` (``rounding`` when None) to the scores in scores.v.
    Returns ``(out in r's dtype, final f32 state)``."""
    bh, t, dk = r.shape
    dv, heads = v.shape[2], u.shape[0]
    n, ns = t // chunk, chunk // sub
    rf, kf, vf = (x.float().reshape(bh, n, chunk, -1) for x in (r, k, v))
    uf = u.float().repeat(bh // heads, 1)[:, None, None, None, :]
    a_inc = torch.cumsum(torch.log2(torch.clamp(w.float(), min=1e-30))
                         .reshape(bh, n, chunk, dk), dim=2)
    a_exc = F.pad(a_inc, (0, 0, 1, 0))[:, :, :-1]
    ends = a_inc[:, :, sub - 1::sub]                  # E_j
    prev = F.pad(ends, (0, 0, 1, 0))[:, :, :-1]       # P_i
    band = torch.arange(chunk) // sub

    def e2(x):
        return torch.exp2(torch.clamp(x, max=0))

    def rnd(x):
        return _rounded(x, rounding)

    def rnd_pv(x):
        return _rounded(x, pv_rounding or rounding)

    def blocks(x):
        return x.reshape(bh, n, ns, sub, -1)

    rb, kb = blocks(rf), blocks(kf)
    pair = torch.einsum("bnitd,bnisd,bnitsd->bnits", rb, kb,
                        e2(blocks(a_exc)[..., :, None, :]
                           - blocks(a_inc)[..., None, :, :]))
    # a band's second half against its first, factored at the first
    # half's last step (f32 on either route)
    half = sub // 2
    mid = blocks(a_inc)[..., half - 1:half, :]
    r_mid = rb[..., half:, :] * e2(blocks(a_exc)[..., half:, :] - mid)
    k_mid = kb[..., :half, :] * e2(mid - blocks(a_inc)[..., :half, :])
    pair[..., half:, :half] = r_mid @ k_mid.mT
    diag = (pair * torch.tril(torch.ones(sub, sub), -1)
            + torch.diag_embed((rb * uf * kb).sum(-1)))
    r_hat = rf * e2(a_exc - prev[:, :, band])
    k_til = kf * e2(ends[:, :, band] - a_inc)
    scores = torch.zeros(bh, n, chunk, chunk)
    for i in range(ns):
        rows = slice(sub * i, sub * (i + 1))
        scores[:, :, rows, rows] = diag[:, :, i]
        for j in range(i):
            cols = slice(sub * j, sub * (j + 1))
            g = e2(prev[:, :, i] - ends[:, :, j])[:, :, None]
            scores[:, :, rows, cols] = (rnd(r_hat[:, :, rows] * g)
                                        @ rnd(k_til[:, :, cols]).mT)
    r_dec = r_hat * e2(prev)[:, :, band]
    a_end = a_inc[:, :, -1]
    d_state = rnd(kf * e2(a_end[:, :, None] - a_inc)).mT @ vf
    decay = e2(a_end)[..., None]
    state = torch.zeros(bh, dk, dv)
    outs = []
    for c in range(n):
        outs.append(rnd(r_dec[:, c]) @ rnd(state)
                    + rnd_pv(scores[:, c]) @ vf[:, c])
        state = torch.addcmul(d_state[:, c], decay[:, c], state)
    return torch.stack(outs, 1).reshape(bh, t, dv).to(r.dtype), state


def route_inputs(seed, decay, dtype, bh=4, t=128):
    """Inputs at the sub-chunked route's widths (dk = dv = 64), two heads:
    f32 numpy arrays (r, k, v, u rounded to bf16 first for the bf16
    route), and the torch tensors in the route's types (w in f32)."""
    if decay == "scalar":
        arrays = scalar_decay_inputs(seed, bh, t, 64, 64)
        arrays[4] = np.zeros((2, 64), np.float32)
    else:
        arrays = lin_inputs(seed, bh, 2, t, 64, 64,
                            decay_strength=3.0 if decay == "strong" else 1.0)
        if decay == "strong":
            arrays[3] = np.minimum(arrays[3], 1e-6)
    tensors = to_torch(arrays)
    if dtype == "bfloat16":
        for i in (0, 1, 2, 4):
            tensors[i] = tensors[i].to(torch.bfloat16)
            arrays[i] = tensors[i].float().numpy()
    return arrays, tensors


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["rwkv", "strong", "scalar"])
def test_subchunked_form_matches_jax_oracle(decay, dtype, chunk, jx):
    """The kernel's factored form, in f32 (its f32 route) and with its
    bf16 route's splits, within the file's tolerances of the JAX
    oracle: 1e-2 on a bf16 output, 2e-4 on an f32 one (1e-3 under strong
    decay);
    the f32 state within 2e-4 (1e-3 under strong decay); never inf or
    NaN."""
    jnp, _, jref, _, _ = jx
    arrays, tensors = route_inputs(40 + chunk, decay, dtype)
    got, state = subchunk_mirror(*tensors, chunk, *ROUTE_ROUNDING[dtype])
    want, want_state = jref.linear_attention_state(*to_jax(jnp, arrays))
    strong = decay == "strong"
    tol = 1e-2 if dtype == "bfloat16" else (1e-3 if strong else 2e-4)
    stol = 1e-3 if strong else 2e-4
    assert got.dtype == DTYPES[dtype]
    assert torch.isfinite(got.float()).all() and torch.isfinite(state).all()
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(as_f32(state), as_f32(want_state), rtol=stol,
                               atol=stol)


def test_subchunked_form_matches_pallas_kernel(jx):
    """The f32 route's form against the Pallas kernel in interpret mode."""
    jnp, jops, _, _, _ = jx
    arrays, tensors = route_inputs(50, "rwkv", "float32", bh=2, t=64)
    got, _ = subchunk_mirror(*tensors, 32)
    want = jops.linear_attn(*to_jax(jnp, arrays), chunk=32, interpret=True)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=2e-4,
                               atol=2e-4)


def test_one_bf16_rounding_would_miss_the_tolerance():
    """Why the bf16 route splits: rounding the decayed operands, scores
    and state to bf16 once (as the flash kernel rounds P) puts the final
    state outside 2e-4 of the recurrence; the kernel's splits keep it
    inside."""
    _, tensors = route_inputs(60, "rwkv", "bfloat16")
    _, want_state = ref.linear_attention_state(*tensors)
    for roundings, inside in ((("bf16", "bf16"), False),
                              (ROUTE_ROUNDING["bfloat16"], True)):
        _, state = subchunk_mirror(*tensors, 64, *roundings)
        assert torch.allclose(state, want_state, rtol=2e-4,
                              atol=2e-4) is inside, roundings


@pytest.mark.parametrize("dtype,dk,dv,chunk,want", [
    (torch.bfloat16, 64, 64, 64, "subchunk"),
    (torch.float32, 64, 64, 64, "subchunk"),
    (torch.bfloat16, 64, 64, 16, "subchunk"),
    (torch.float32, 64, 64, 32, "subchunk"),
    (torch.bfloat16, 64, 64, 8, "serial"),
    (torch.float32, 64, 64, 128, "serial"),
    (torch.bfloat16, 128, 64, 64, "serial"),
    (torch.bfloat16, 64, 32, 64, "serial"),
    (torch.float32, 16, 20, 7, "serial"),
])
def test_kernel_for_routes_by_width_and_chunk(dtype, dk, dv, chunk, want):
    assert la.kernel_for(dtype, dk, dv, chunk) == want


# ------------------------------- the card route's host side (CPU, stubs) ---

class StubEntry:
    """A C entry point: calls ``fn``; takes ``argtypes``/``restype`` as a
    ctypes function does."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class StubLibrary:
    """A stand-in for a build of either source (entry points named by
    ``prefix``): records each launch's unpacked argument block and
    returns ``rc``; the sub-chunked one keeps ``per_chunk`` scratch floats
    a chunk."""

    def __init__(self, prefix, rc=0, args_bytes=la.LINEAR_ARGS.size,
                 per_chunk=64 * 64 + 64):
        self.calls = []

        def launch(packed):
            self.calls.append(la.LINEAR_ARGS.unpack(packed))
            return rc

        setattr(self, f"{prefix}_launch", StubEntry(launch))
        setattr(self, f"{prefix}_args_bytes", StubEntry(lambda: args_bytes))
        setattr(self, f"{prefix}_error_string",
                StubEntry(lambda code: b"stub error"))
        if prefix == "linear_attn_tc":
            self.linear_attn_tc_scratch_floats_per_chunk = StubEntry(
                lambda: per_chunk)


@pytest.fixture
def card_route(monkeypatch, launches):
    """CPU tensors sent down the card route: ``on_card`` says yes, the
    stream is the number 7, and both cached builds are bound stubs
    (loading a real one fails the test)."""
    stubs = {"subchunk": la.bind(StubLibrary("linear_attn_tc"),
                                 "linear_attn_tc"),
             "serial": la.bind(StubLibrary("linear_attn"), "linear_attn")}
    monkeypatch.setattr(la, "on_card", lambda kernel, t: True)
    monkeypatch.setattr(la, "current_stream", lambda t: 7)
    monkeypatch.setattr(la, "_CACHED", dict(stubs))
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail(
        "a cached build was loaded"))
    return stubs


@pytest.mark.parametrize("shape,chunk,variant", [
    ((4, 128, 64, 64), 64, "subchunk"), ((3, 42, 16, 20), 7, "serial")])
def test_card_route_passes_the_packed_argument_block(shape, chunk, variant,
                                                     card_route, launches):
    """One launch of the routed kernel, one packed block, field for field:
    the operands', output's and state's addresses, the scratch (the
    sub-chunked kernel's, sized by ``scratch_floats``; 0 for the serial
    kernel), the stream, then the sizes and dtype codes."""
    bh, t, dk, dv = shape
    r, k, v, w, u = to_torch(lin_inputs(3, bh, bh, t, dk, dv))
    r, k, v, u = (x.to(torch.bfloat16) for x in (r, k, v, u))
    out, state = la.linear_attention_state(r, k, v, w, u, chunk=chunk)
    (args,) = card_route[variant].calls
    other = "serial" if variant == "subchunk" else "subchunk"
    assert not card_route[other].calls
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), state.data_ptr())
    assert args[:7] == ptrs
    assert (args[7] != 0) == (variant == "subchunk")
    assert args[8:] == (7, bh, t, dk, dv, bh, chunk, 1, 0, 1)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (bh, t, dv)
    assert state.dtype == torch.float32 and tuple(state.shape) == (bh, dk,
                                                                   dv)
    assert dict(la.VARIANTS) == {variant: 1} and launches["linear_attn"] == 1
    assert la.scratch_floats(card_route["subchunk"], bh, t,
                             chunk) == bh * (t // chunk) * 4160


@pytest.mark.parametrize("rc", [0, 1])
def test_mamba2_prefill_reaches_the_kernel_in_f32_and_never_falls_back(
        rc, card_route, monkeypatch, launches):
    """A bf16 Mamba2 layer (one head of 64, d_state 64) sends its prefill
    down the card route as one launch of the sub-chunked kernel with
    every operand f32 (its ``v = dt·x`` is f32, so ``r`` and ``k`` are
    lifted); a launch the kernel refuses raises ``DeviceError`` out of the
    layer, and the chunked form is never run in its place."""
    monkeypatch.setitem(la._CACHED, "subchunk", la.bind(
        StubLibrary("linear_attn_tc", rc=rc), "linear_attn_tc"))
    monkeypatch.setattr(LB, "linear_attention_chunked", lambda *a, **k:
                        pytest.fail("fell back to the chunked form"))
    layer = LB.Mamba2(32, d_state=64, impl="kernel", dtype=torch.bfloat16,
                      device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 64, 32, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    if rc:
        with pytest.raises(DeviceError, match="launch failed"):
            layer(x)
        assert not launches
        return
    out, state = layer(x)
    (args,) = la._CACHED["subchunk"].calls
    assert args[9:] == (2, 64, 64, 64, 1, 64, 0, 0, 0)
    assert out.dtype == torch.bfloat16 and state["ssm"].dtype == torch.float32
    assert launches["linear_attn"] == 1
    assert la.SHAPES == {(2, 64, 64, 64, 64, torch.float32): 1}


def test_scratch_is_sized_by_the_library():
    """The sub-chunked kernel's scratch is the size its build states
    (read once, when bound), not a copy of its formula."""
    lib = la.bind(StubLibrary("linear_attn_tc", per_chunk=10),
                  "linear_attn_tc")
    assert lib.scratch_floats_per_chunk == 10
    assert la.scratch_floats(lib, 6, 128, 32) == 6 * 4 * 10


def refused_operands():
    """``(label, operands, chunk, message)`` for each operand the kernels
    refuse, as CPU tensors."""
    r, k, v, w, u = to_torch(lin_inputs(5, 2, 2, 64, 64, 64))
    long = to_torch(lin_inputs(5, 2, 2, 128, 16, 16))
    wide = to_torch(lin_inputs(5, 2, 2, 64, 192, 16))
    return [
        ("mixed dtypes", (r, k.bfloat16(), v, w, u), 64, "k is"),
        ("not contiguous", (r.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, w, u), 64, "contiguous"),
        ("half precision", (r.half(), k.half(), v.half(), w, u), 64,
         "float32 or bfloat16"),
        ("serial chunk above 64", tuple(long), 128, "exceed"),
        ("serial dk above 128", tuple(wide), 16, "exceed"),
        ("u on another device", (r, k, v, w, u.to("meta")), 64, "is on"),
    ]


@pytest.mark.parametrize("case", range(len(refused_operands())),
                         ids=[c[0] for c in refused_operands()])
def test_card_route_refuses_before_any_launch(case, card_route, launches):
    """The fast check refuses exactly what ``check_operands`` names, as a
    DeviceError, before any library is touched or any launch counted."""
    _, operands, chunk, match = refused_operands()[case]
    assert not la.takes(*operands, chunk)
    with pytest.raises(DeviceError, match=match):
        la.linear_attention_state(*operands, chunk=chunk)
    assert not any(stub.calls for stub in card_route.values())
    assert not launches and not la.VARIANTS


def test_refused_launch_raises_and_counts_nothing(card_route, monkeypatch,
                                                  launches):
    monkeypatch.setitem(la._CACHED, "subchunk", la.bind(
        StubLibrary("linear_attn_tc", rc=1), "linear_attn_tc"))
    arrays = to_torch(lin_inputs(4, 2, 2, 64, 64, 64))
    with pytest.raises(DeviceError, match="subchunk kernel launch failed"):
        la.linear_attention(*arrays, chunk=64)
    assert not launches and not la.VARIANTS


def test_a_library_of_another_argument_layout_is_refused():
    with pytest.raises(DeviceError, match="linear_attn_tc_args_bytes"):
        la.bind(StubLibrary("linear_attn_tc",
                            args_bytes=la.LINEAR_ARGS.size - 8),
                "linear_attn_tc")


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
#: bonus, zamba2-1.2b's prefill (64 heads, its decay spectrum, f32), and
#: f32 throughout; then a small odd chunk with a ragged dv.
CARD_CASES = [
    ("path", (32, 512, 64, 64), "bfloat16", "rwkv", False, 64),
    ("padded", (32, 300, 64, 64), "bfloat16", "rwkv", True, 64),
    ("strong_decay", (32, 512, 64, 64), "float32", "strong", False, 64),
    ("scalar_decay_u0", (32, 512, 64, 64), "float32", "scalar", False, 64),
    ("mamba2_path", (64, 512, 64, 64), "float32", "zamba2", False, 64),
    ("f32", (32, 512, 64, 64), "float32", "rwkv", False, 64),
    ("odd_chunk", (3, 42, 16, 20), "float32", "rwkv", False, 7),
    ("chunk16", (32, 512, 64, 64), "bfloat16", "rwkv", False, 16),
    ("chunk32", (32, 512, 64, 64), "bfloat16", "rwkv", False, 32),
    ("chunk16_strong_f32", (32, 512, 64, 64), "float32", "strong", False,
     16),
    ("chunk32_f32", (32, 512, 64, 64), "float32", "rwkv", False, 32),
]


def card_inputs(seed, shape, dtype, decay):
    bh, t, dk, dv = shape
    if decay == "scalar":
        arrays = scalar_decay_inputs(seed, bh, t, dk, dv)
    elif decay == "zamba2":
        arrays = zamba2_decay_inputs(seed, bh, 64, t, dk, dv)
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
    assert la.VARIANTS == {la.kernel_for(r.dtype, shape[2], shape[3],
                                         chunk): 1}
    want, want_state = ref.linear_attention_state(r, k, v, w, u)
    strong = decay in ("strong", "zamba2")
    tol = 1e-2 if dtype == "bfloat16" else (1e-3 if strong else 2e-4)
    stol = 1e-3 if strong else 2e-4
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_subchunk_kernel_reads_unaligned_operands(dtype, launches):
    """Operands whose bases are off the vector loads' alignment (contiguous
    views two bytes or four bytes in) take the kernel's element loads and
    give the same result."""
    card()
    r, k, v, w, u = card_inputs(31, (8, 128, 64, 64), dtype, "rwkv")

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        return view

    got, state = la.linear_attention_state(
        *(shifted(x) for x in (r, k, v, w)), u, chunk=64)
    torch.cuda.synchronize()
    assert la.VARIANTS == {"subchunk": 1}
    want, want_state = ref.linear_attention_state(r, k, v, w, u)
    tol = 1e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, want_state, rtol=2e-4, atol=2e-4)
