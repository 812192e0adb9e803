"""The port's gradient compression (``repro_torch.parallel.compression``)
against the JAX package's (``repro.parallel.compression``), on the CPU,
on numpy-seeded inputs: the int8 codes and scales bit for bit, the
dequantized values and residuals exactly (the same f32 arithmetic), and
top-k's kept set exactly."""
import numpy as np
import pytest
import torch

# the JAX package is the reference; a card without it skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.parallel import compression as jcomp

from repro_torch.parallel import compression as comp

SHAPES = ((7,), (16, 33), (3, 5, 8))


def seeded(shape, seed, dtype=np.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32).astype(dtype)


def to_torch(x):
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1.0, 1e-20, 0.0])
def test_compress_matches_jax(shape, scale):
    x = seeded(shape, 1, scale=scale)
    q, s = comp.compress(torch.from_numpy(x))
    jq, js = jcomp.compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decompress_matches_jax(dtype):
    x = seeded((64, 16), 2)
    q, s = comp.compress(torch.from_numpy(x))
    tdt = getattr(torch, dtype)
    got = comp.decompress(q, s, tdt)
    want = jcomp.decompress(jnp.asarray(q.numpy()), jnp.float32(float(s)),
                            getattr(jnp, dtype))
    assert got.dtype == tdt
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_int8_matches_jax(dtype):
    np_dt = jnp.dtype(dtype)
    tree = {"a": seeded((8, 8), 3, np_dt),
            "b": {"c": seeded((5,), 4, np_dt), "d": seeded((2, 3, 4), 5,
                                                           np_dt)}}
    got = comp.fake_quant_int8(jax.tree.map(to_torch, tree))
    want = jcomp.fake_quant_int8(jax.tree.map(jnp.asarray, tree))
    assert set(got) == {"a", "b"} and set(got["b"]) == {"c", "d"}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(f32(g), f32(w))


def test_ef_init_matches_jax():
    tree = {"w": seeded((4, 6), 6), "b": seeded((6,), 7)}
    got = comp.ef_init(jax.tree.map(to_torch, tree))
    want = jcomp.ef_init(jax.tree.map(jnp.asarray, tree))
    for k in tree:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_ef_compress_matches_jax_over_steps():
    """Three steps of error feedback: each step's dequantized tree and
    residual equal JAX's."""
    res_t = comp.ef_init({"w": torch.zeros(32, 16), "b": torch.zeros(16)})
    res_j = jcomp.ef_init({"w": jnp.zeros((32, 16)), "b": jnp.zeros(16)})
    for step in range(3):
        g = {"w": seeded((32, 16), 10 + step), "b": seeded((16,), 20 + step)}
        deq_t, res_t = comp.ef_compress(jax.tree.map(to_torch, g), res_t)
        deq_j, res_j = jcomp.ef_compress(jax.tree.map(jnp.asarray, g), res_j)
        for k in g:
            np.testing.assert_array_equal(deq_t[k].numpy(),
                                          np.asarray(deq_j[k]))
            np.testing.assert_array_equal(res_t[k].numpy(),
                                          np.asarray(res_j[k]))


@pytest.mark.parametrize("k_fraction", [0.01, 0.1, 0.5, 1e-9])
def test_topk_sparsify_matches_jax(k_fraction):
    x = seeded((40, 25), 8)
    got = comp.topk_sparsify(torch.from_numpy(x), k_fraction)
    want = jcomp.topk_sparsify(jnp.asarray(x), k_fraction)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.count_nonzero(got.numpy()) == max(int(x.size * k_fraction), 1)
