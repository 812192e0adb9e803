"""The port's dense LM substrate against the JAX package's.

Weights come from the JAX package's ``init`` and are carried over with
``repro_torch.carry.import_lm_params``; token ids are drawn with numpy.
Both packages then compute the same function on the CPU:

* layers and attention implementations, in f32, at rtol/atol 1e-5 (the
  same arithmetic in another order);
* ``forward`` logits, and ``prefill`` followed by three ``decode_step``s,
  for the four dense smoke configs in f32 at rtol/atol 1e-4 (measured
  errors are below 3e-6 on logits up to 4; 28 layers of the full model
  are never run here), against the JAX ``"chunked"`` route and, in one
  case, against the JAX ``"kernel"`` route (the Pallas kernel in
  interpret mode);
* one bf16 case at rtol/atol 2e-2 (bf16 keeps 8 bits of mantissa and the
  two packages round at different places).

RWKV6 (``rwkv6-1.6b``'s smoke config) is held the same way: ``forward``
and ``prefill`` (logits and every layer's ``{wkv, shift1, shift2}``
state) followed by three ``decode_step``s in f32 at rtol/atol 1e-4,
through both of the port's prefill routes (``"kernel"``, the kernel's
plain version on the CPU, and ``"chunked"``).  In bf16 its logits reach
3.5, where a bf16 ulp is 0.0156, and the JAX package's own jit and eager
runs of the same forward differ by up to 0.053 on them; the port is held
at rtol 2e-2 and atol 0.1 there (measured: within 0.07).

zamba2 (``zamba2-1.2b``'s smoke config: five Mamba2 layers and the
weight-shared attention block at two sites) is held as RWKV6 is: the
causal conv and one Mamba2 layer (prefill output and final
``{ssm, conv}``, then four decode steps) against ``mamba2_block``, and
the model's ``forward``, ``prefill`` and ``decode_step`` (logits and
every cache entry, each Mamba2 state and each shared site's k/v) in f32
at rtol/atol 1e-4 through both prefill routes, and in bf16 at RWKV6's
bf16 tolerance (measured: within 0.032 on logits up to 0.66).

The full-width configs are checked for structure only, on the ``meta``
device: the port's parameter count equals the JAX package's, and the
port's stack walk visits JAX's segment plan.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import _flatten, import_lm_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DENSE = ("qwen3-0.6b", "qwen3-4b", "qwen1.5-4b", "gemma2-2b")
FULL_PARAMS = {"qwen3-0.6b": 596_049_920, "rwkv6-1.6b": 1_678_313_472,
               "zamba2-1.2b": 1_104_777_344}
RWKV = "rwkv6-1.6b"
ZAMBA = "zamba2-1.2b"


@pytest.fixture(scope="module")
def jx():
    """``jax``, ``jax.numpy`` and the JAX package's configs, layers,
    attention and transformer."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import attention as JA
    from repro.models import layers as JL
    from repro.models import transformer as JT
    return jax, jnp, jconfigs, JL, JA, JT


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, jax_impl, seed):
    """The JAX config and weights (numpy leaves) and the port's model with
    the same weights, for ``arch``'s smoke config."""
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), param_dtype=dtype,
                               attn_impl=jax_impl)
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(seed)))
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype=dtype)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(cfg, params), strict=True)
    return jcfg, params, model


def pair(arch, dtype="float32", jax_impl="chunked", seed=0):
    return _pair(arch, dtype, jax_impl, seed)


def tokens(cfg, seed, b, t):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t),
                                                dtype=np.int32)


# --------------------------------------------------------------- layers ---

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_matches_jax(zero_centered, jx):
    _, jnp, _, JL, _, _ = jx
    x, scale = normal(1, 3, 5, 32), normal(2, 32)
    got = L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale),
                    zero_centered=zero_centered)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                      zero_centered=zero_centered)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 4, 16), (2, 7, 16)])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rotary_matches_jax(shape, theta, jx):
    _, jnp, _, JL, _, _ = jx
    x = normal(3, *shape)
    pos = np.arange(100, 107, dtype=np.int32)[None].repeat(2, 0)
    got = L.rotary(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.rotary(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlps_match_jax(kind, jx):
    jax, jnp, _, JL, _, _ = jx
    init = JL.gelu_mlp_init if kind == "gelu" else JL.swiglu_init
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(4), 24, 40))
    mlp = L.MLP(24, 40, kind, dtype=torch.float32, device="cpu",
                generator=None)
    mlp.load_state_dict({f"{k}.w": torch.from_numpy(np.array(v["w"]))
                         for k, v in p.items()})
    x = normal(5, 3, 24)
    apply = {"swiglu": JL.swiglu, "geglu": JL.geglu,
             "gelu": JL.gelu_mlp}[kind]
    want = apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(f32(mlp(torch.from_numpy(x))), f32(want),
                               rtol=1e-5, atol=1e-5)


def test_softcap_and_embeddings_match_jax(jx):
    _, jnp, _, JL, _, _ = jx
    x, table = normal(6, 4, 9) * 40, normal(7, 11, 9)
    toks = np.array([[3, 0, 10]], dtype=np.int32)
    for cap in (0.0, 30.0):
        np.testing.assert_allclose(
            f32(L.softcap(torch.from_numpy(x), cap)),
            f32(JL.softcap(jnp.asarray(x), cap)), rtol=1e-5, atol=1e-5)
    emb = L.embed(torch.from_numpy(table), torch.from_numpy(toks))
    np.testing.assert_array_equal(
        f32(emb), f32(JL.embed({"table": jnp.asarray(table)},
                               jnp.asarray(toks))))
    np.testing.assert_allclose(
        f32(L.unembed(torch.from_numpy(table), emb)),
        f32(JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(f32(emb)))),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ attention ---

ATTN_CASES = [  # b, t, h, hkv, dh, causal, window, cap
    (2, 24, 4, 2, 16, True, 0, 0.0),
    (1, 40, 4, 1, 8, True, 8, 0.0),
    (2, 33, 2, 2, 16, True, 0, 50.0),
    (1, 16, 4, 2, 16, False, 0, 0.0),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_attention_impls_match_jax_naive(case, impl, jx):
    _, jnp, _, _, JA, _ = jx
    b, t, h, hkv, dh, causal, window, cap = case
    q, k, v = normal(8, b, t, h, dh), normal(9, b, t, hkv, dh), \
        normal(10, b, t, hkv, dh)
    kw = dict(causal=causal, window=window, cap=cap)
    if impl == "chunked":
        kw["chunk"] = 16                     # several chunks, a ragged one
    got = A.IMPLS[impl](*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = JA.attention_naive(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (0, 50.0)])
def test_attention_decode_matches_jax(window, cap, jx):
    _, jnp, _, _, JA, _ = jx
    q, kc, vc = normal(11, 2, 1, 4, 16), normal(12, 2, 20, 2, 16), \
        normal(13, 2, 20, 2, 16)
    got = A.attention_decode(*(torch.from_numpy(a) for a in (q, kc, vc)),
                             length=13, window=window, cap=cap)
    want = JA.attention_decode(*(jnp.asarray(a) for a in (q, kc, vc)),
                               length=jnp.int32(13), window=window, cap=cap)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_kernel_impl_refuses_an_offset():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        A.attention_kernel(q, q, q, offset=3)


# ---------------------------------------------------------------- models ---

@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = pair(arch)
    toks = tokens(jcfg, 1, 2, 24)
    fa.LAUNCHES.clear()
    got, aux = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                         {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert not fa.LAUNCHES                  # CPU: the plain version
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = pair(arch)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 2, 2, 20)
    max_len = 24
    got, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :17])},
                           max_len)
    want, jcache = JT.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :17])}, max_len)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    n_pat = len(jcfg.pattern)
    for n, c in enumerate(cache):           # layer n = blocks{i}[period]
        jc = jcache[f"blocks{n % n_pat}"]
        for name in ("k", "v"):
            assert tuple(c[name].shape) == (2, max_len, jcfg.n_kv, jcfg.hd)
            np.testing.assert_allclose(f32(c[name]),
                                       f32(jc[name][n // n_pat]),
                                       rtol=1e-4, atol=1e-4)
    for i in range(17, 20):
        tok = toks[:, i:i + 1]
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache, i + 1)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      jnp.int32(i + 1))
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch}: decode at {i}")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b"])
def test_forward_matches_jax_pallas_kernel_route(arch, jx):
    """The JAX package's ``attn_impl="kernel"``: the Pallas flash kernel in
    interpret mode, against the port's kernel route (its plain version
    here), on a length the wrappers pad (130 -> 256 with 128-row
    blocks)."""
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = pair(arch, jax_impl="kernel")
    assert model.cfg.attn_impl == "kernel"
    toks = tokens(jcfg, 3, 1, 130)
    got, _ = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                         {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma2-2b"])
def test_decoding_from_an_empty_cache_matches_forward(arch):
    """Token by token from ``init_cache`` (window, softcap and sandwich
    norms on gemma2), the logits are the full forward's."""
    _, _, model = pair(arch)
    batch = configs.smoke_batch(model.cfg, batch=2, seq=12, train=False,
                                seed=6, device="cpu")
    assert batch["tokens"].dtype == torch.int32 and "labels" not in batch
    full, _ = T.forward(model, batch)
    cache = T.init_cache(model.cfg, 2, 12, device="cpu")
    assert len(cache) == model.cfg.n_layers
    for i in range(12):
        got, cache = T.decode_step(model, batch["tokens"][:, i:i + 1], cache,
                                   i + 1)
        torch.testing.assert_close(got[:, 0], full[:, i], rtol=1e-5,
                                   atol=1e-5)


def test_smoke_batch_is_seeded_and_on_the_asked_device():
    cfg = configs.get_smoke("qwen3-0.6b")
    a = configs.smoke_batch(cfg, batch=3, seq=5, seed=2, device="cpu")
    b = configs.smoke_batch(cfg, batch=3, seq=5, seed=2, device="cpu")
    assert sorted(a) == ["labels", "tokens"]
    assert tuple(a["tokens"].shape) == (3, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].max()) < cfg.vocab


def test_bf16_forward_and_decode_match_jax(jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = pair("gemma2-2b", dtype="bfloat16")
    assert model.embed.table.dtype == torch.bfloat16
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 4, 2, 16)
    got, _ = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    _, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :15])},
                         16)
    _, jcache = JT.prefill(jcfg, jparams,
                           {"tokens": jnp.asarray(toks[:, :15])}, 16)
    got, _ = T.decode_step(model, torch.from_numpy(toks[:, 15:]), cache, 16)
    want, _ = JT.decode_step(jcfg, jparams, jnp.asarray(toks[:, 15:]), jcache,
                             jnp.int32(16))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_naive_chunked_and_kernel_routes_agree():
    _, _, model = pair("gemma2-2b")
    toks = torch.from_numpy(tokens(model.cfg, 5, 2, 20))
    outs = {}
    for impl in ("naive", "chunked", "kernel"):
        m = T.Transformer(dataclasses.replace(model.cfg, attn_impl=impl),
                          device="cpu")
        m.load_state_dict(model.state_dict())
        outs[impl], _ = T.forward(m, {"tokens": toks})
    for impl in ("chunked", "kernel"):
        torch.testing.assert_close(outs[impl], outs["naive"], rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------- RWKV6 ---

def model_pair(arch, dtype="float32", impl="kernel", seed=0):
    """``pair`` with the port's prefill route ``impl`` (the JAX package's
    recurrent blocks ignore ``attn_impl``)."""
    jcfg, params, model = pair(arch, dtype, seed=seed)
    if impl != model.cfg.attn_impl:
        m = T.Transformer(dataclasses.replace(model.cfg, attn_impl=impl),
                          device="cpu")
        m.load_state_dict(model.state_dict())
        model = m
    return jcfg, params, model


def rwkv_pair(dtype="float32", impl="kernel", seed=0):
    """``model_pair`` for rwkv6-1.6b-smoke."""
    return model_pair(RWKV, dtype, impl, seed)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_rwkv6_forward_matches_jax(impl, jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = rwkv_pair(impl=impl)
    assert model.layers[0].impl == impl
    toks = tokens(jcfg, 7, 2, 40)            # 40 = 2 chunks of 16 + 8
    got, aux = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                         {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_rwkv6_prefill_and_decode_match_jax(impl, jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = rwkv_pair(impl=impl)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 8, 2, 20)
    max_len = 24
    got, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :17])},
                           max_len)
    want, jcache = JT.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :17])}, max_len)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    h, hd = jcfg.d_model // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    for n, c in enumerate(cache):
        jc = jcache["blocks0"]
        assert sorted(c) == ["shift1", "shift2", "wkv"]
        assert tuple(c["wkv"].shape) == (2, h, hd, hd)
        assert c["wkv"].dtype == torch.float32
        for name in c:
            np.testing.assert_allclose(f32(c[name]), f32(jc[name][n]),
                                       rtol=1e-4, atol=1e-4)
    for i in range(17, 20):
        tok = toks[:, i:i + 1]
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache, i + 1)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      jnp.int32(i + 1))
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"rwkv6: decode at {i}")


def test_rwkv6_bf16_forward_and_decode_match_jax(jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = rwkv_pair(dtype="bfloat16")
    assert model.layers[0].wr.w.dtype == torch.bfloat16
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 9, 2, 24)
    got, _ = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=0.1)
    _, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :21])},
                         24)
    _, jcache = JT.prefill(jcfg, jparams,
                           {"tokens": jnp.asarray(toks[:, :21])}, 24)
    assert cache[0]["shift1"].dtype == torch.bfloat16
    for i in range(21, 24):
        tok = toks[:, i:i + 1]
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache, i + 1)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      jnp.int32(i + 1))
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=0.1)


def test_rwkv6_decoding_from_an_empty_cache_matches_forward():
    """Token by token from ``init_cache``, the logits are the full
    forward's."""
    _, _, model = rwkv_pair()
    batch = configs.smoke_batch(model.cfg, batch=2, seq=12, train=False,
                                seed=6, device="cpu")
    full, _ = T.forward(model, batch)
    cache = T.init_cache(model.cfg, 2, 12, device="cpu")
    assert len(cache) == model.cfg.n_layers
    assert all(torch.count_nonzero(c["wkv"]) == 0 for c in cache)
    for i in range(12):
        got, cache = T.decode_step(model, batch["tokens"][:, i:i + 1], cache,
                                   i + 1)
        torch.testing.assert_close(got[:, 0], full[:, i], rtol=1e-5,
                                   atol=1e-5)


def test_rwkv6_kernel_route_equals_chunked_route():
    """The port's two prefill routes (``"kernel"``: on the CPU the exact
    recurrence; ``"chunked"``: the closed form) agree, logits and final
    states, on a length that is no multiple of the chunk."""
    _, _, kernel = rwkv_pair(impl="kernel")
    _, _, chunked = rwkv_pair(impl="chunked")
    toks = torch.from_numpy(tokens(kernel.cfg, 10, 2, 37))
    got, cache = T.prefill(kernel, {"tokens": toks}, 40)
    want, want_cache = T.prefill(chunked, {"tokens": toks}, 40)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for c, w in zip(cache, want_cache):
        for name in c:
            torch.testing.assert_close(c[name], w[name], rtol=1e-5,
                                       atol=1e-5)


def test_rwkv6_weights_follow_the_jax_initialisers():
    """The JAX package's ``rwkv6_init`` distributions, drawn from the
    generator: decay projection ``ww`` at scale 0.01 (truncated at 2
    sigma), ``w_bias`` -4, the mixes in [0.25, 0.75], the bonus at 0.1."""
    cfg = configs.get_smoke(RWKV)
    model = T.Transformer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    layer = model.layers[0]
    assert set(name for name, _ in layer.named_children()) >= {
        "ln1", "ln2", "wr", "wk", "wv", "wg", "ww", "gn", "wo", "ck", "cv",
        "cr"}
    assert float(layer.ww.w.abs().max()) <= 0.02 + 1e-7
    assert float(layer.ww.w.std()) > 0.003
    assert float(layer.wr.w.abs().max()) > 0.02     # 1/sqrt(d), not 0.01
    assert torch.all(layer.w_bias == -4.0)
    for mix in (layer.mix, layer.cmix):
        assert float(mix.min()) >= 0.25 and float(mix.max()) <= 0.75
    assert tuple(layer.bonus.shape) == (cfg.d_model // cfg.rwkv_head_dim,
                                        cfg.rwkv_head_dim)
    assert 0.05 < float(layer.bonus.std()) < 0.2


# ------------------------------------------------ Mamba2 and zamba2 ---

def mamba2_pair(jx, impl="kernel"):
    """The JAX package's Mamba2 parameters (numpy) at the zamba2 smoke
    widths (d 64, d_state 16, 2 heads of 64) and the port's layer with
    them."""
    from repro_torch.models.linear_blocks import Mamba2
    jax, _, _, _, _, _ = jx
    from repro.models import linear_blocks as JLB
    p = jax.tree.map(np.asarray, JLB.mamba2_init(jax.random.PRNGKey(3), 64,
                                                 d_state=16))
    layer = Mamba2(64, d_state=16, chunk=16, impl=impl, dtype=torch.float32,
                   device="cpu", generator=None)
    layer.load_state_dict({name: torch.from_numpy(np.array(a))
                           for name, a in _flatten(p, "").items()},
                          strict=True)
    return JLB, p, layer


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches_jax(cached, jx):
    from repro_torch.models.linear_blocks import _causal_conv
    _, jnp, _, _, _, _ = jx
    from repro.models import linear_blocks as JLB
    x, kernel = normal(20, 2, 7, 12), normal(21, 4, 12)
    cache = normal(22, 2, 3, 12) if cached else None
    got, got_cache = _causal_conv(
        torch.from_numpy(x), torch.from_numpy(kernel),
        None if cache is None else torch.from_numpy(cache))
    want, want_cache = JLB._causal_conv(
        jnp.asarray(x), jnp.asarray(kernel),
        None if cache is None else jnp.asarray(cache))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(f32(got_cache), f32(want_cache))
    np.testing.assert_array_equal(f32(got_cache), x[:, -3:])


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_mamba2_prefill_and_decode_match_jax(impl, jx):
    """One layer: prefill (``state=None``) output and final ``{ssm,
    conv}``, then four decode steps from that state, each output and
    state."""
    jax, jnp, _, _, _, _ = jx
    JLB, p, layer = mamba2_pair(jx, impl)
    jp = jax.tree.map(jnp.asarray, p)
    x = normal(23, 2, 25, 64)               # 25 = a chunk of 16 + 9
    kw = dict(d_state=16, chunk=16)
    got, state = layer(torch.from_numpy(x[:, :21]))
    want, jstate = JLB.mamba2_block(jp, jnp.asarray(x[:, :21]), **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    assert sorted(state) == ["conv", "ssm"]
    assert tuple(state["ssm"].shape) == (2, 2, 16, 64)
    assert state["ssm"].dtype == torch.float32
    for name in state:
        np.testing.assert_allclose(f32(state[name]), f32(jstate[name]),
                                   rtol=1e-4, atol=1e-4)
    buffers = dict(state)
    for i in range(21, 25):
        got, state = layer(torch.from_numpy(x[:, i:i + 1]), None, state)
        want, jstate = JLB.mamba2_block(jp, jnp.asarray(x[:, i:i + 1]),
                                        state=jstate, **kw)
        assert all(state[name] is buffers[name] for name in buffers)
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode at {i}")
        for name in state:
            np.testing.assert_allclose(f32(state[name]), f32(jstate[name]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_zamba2_forward_matches_jax(impl, jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = model_pair(ZAMBA, impl=impl)
    assert model.layers[0].impl == impl and model.shared is not None
    toks = tokens(jcfg, 11, 2, 40)           # 40 = 2 chunks of 16 + 8
    got, aux = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                         {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


def assert_zamba2_cache_matches(cfg, cache, jcache, tol):
    """Every entry of the port's cache against JAX's tree: layer ``n``'s
    ``{ssm, conv}`` against ``blocks0[n]``, site ``s``'s ``{k, v}``
    against ``shared[s]``."""
    assert len(cache) == cfg.n_layers + cfg.n_shared_sites
    for n in range(cfg.n_layers):
        assert sorted(cache[n]) == ["conv", "ssm"]
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(
                f32(cache[n][name]), f32(jcache["blocks0"][name][n]),
                rtol=tol, atol=tol, err_msg=f"layer {n} {name}")
    for s in range(cfg.n_shared_sites):
        for name in ("k", "v"):
            jc = jcache["shared"][name][s]
            assert tuple(cache[cfg.n_layers + s][name].shape) == jc.shape
            np.testing.assert_allclose(
                f32(cache[cfg.n_layers + s][name]), f32(jc), rtol=tol,
                atol=tol, err_msg=f"site {s} {name}")


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_zamba2_prefill_and_decode_match_jax(impl, jx):
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = model_pair(ZAMBA, impl=impl)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 12, 2, 21)
    max_len = 24
    got, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :17])},
                           max_len)
    want, jcache = JT.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :17])}, max_len)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    assert_zamba2_cache_matches(model.cfg, cache, jcache, 1e-4)
    for i in range(17, 21):
        tok = toks[:, i:i + 1]
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache, i + 1)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      jnp.int32(i + 1))
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"zamba2: decode at {i}")
        assert_zamba2_cache_matches(model.cfg, cache, jcache, 1e-4)


def test_zamba2_bf16_forward_and_decode_match_jax(jx):
    """At ``test_rwkv6_bf16_forward_and_decode_match_jax``'s tolerance;
    the Mamba2 layers keep ``a_log``, ``dt_bias`` and ``d_skip`` in f32."""
    jax, jnp, _, _, _, JT = jx
    jcfg, params, model = model_pair(ZAMBA, dtype="bfloat16")
    layer = model.layers[0]
    assert layer.in_proj.w.dtype == torch.bfloat16
    assert {layer.a_log.dtype, layer.dt_bias.dtype,
            layer.d_skip.dtype} == {torch.float32}
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 13, 2, 24)
    got, _ = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=0.1)
    _, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :21])},
                         24)
    _, jcache = JT.prefill(jcfg, jparams,
                           {"tokens": jnp.asarray(toks[:, :21])}, 24)
    assert cache[0]["conv"].dtype == torch.bfloat16
    assert cache[0]["ssm"].dtype == torch.float32
    for i in range(21, 24):
        tok = toks[:, i:i + 1]
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache, i + 1)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      jnp.int32(i + 1))
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=0.1)


def test_zamba2_decoding_from_an_empty_cache_matches_forward():
    """Token by token from ``init_cache`` (zero Mamba2 states, zero site
    caches), the logits are the full forward's."""
    _, _, model = model_pair(ZAMBA)
    cfg = model.cfg
    batch = configs.smoke_batch(cfg, batch=2, seq=12, train=False, seed=6,
                                device="cpu")
    full, _ = T.forward(model, batch)
    cache = T.init_cache(cfg, 2, 12, device="cpu")
    assert len(cache) == cfg.n_layers + cfg.n_shared_sites
    assert [sorted(c) for c in cache] == (
        [["conv", "ssm"]] * cfg.n_layers + [["k", "v"]] * cfg.n_shared_sites)
    for i in range(12):
        got, cache = T.decode_step(model, batch["tokens"][:, i:i + 1], cache,
                                   i + 1)
        torch.testing.assert_close(got[:, 0], full[:, i], rtol=1e-5,
                                   atol=1e-5)


class Recorder(torch.nn.Module):
    """A stand-in layer that logs its name when applied and returns its
    input and a cache naming it."""

    def __init__(self, name, log):
        super().__init__()
        self.name, self.log = name, log

    def forward(self, x, positions, cache=None, length=None):
        self.log.append(self.name)
        return x, {"from": self.name}


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_walk_visits_the_jax_segment_plan(which, jx):
    """The walk applies the layers and the shared block in the order of
    JAX's ``segments()``, and returns the caches as layers then sites."""
    _, _, jconfigs, _, _, _ = jx
    get = configs.get_smoke if which == "smoke" else configs.get_config
    jget = jconfigs.get_smoke if which == "smoke" else jconfigs.get_config
    cfg, jcfg = get(ZAMBA), jget(ZAMBA)
    assert cfg.segments() == jcfg.segments()
    assert cfg.n_shared_sites == jcfg.n_shared_sites
    want = []
    for p0, p1, shared_after in jcfg.segments():
        want += [f"layer{n}" for n in range(p0, p1)]
        want += ["shared"] if shared_after else []
    model = T.Transformer(cfg, device="meta")
    log = []
    model.layers = torch.nn.ModuleList(Recorder(f"layer{n}", log)
                                       for n in range(cfg.n_layers))
    model.shared = Recorder("shared", log)
    x = torch.zeros(1, 3, 4)
    out, cache = T._walk(model, x, torch.zeros(1, 3, dtype=torch.long))
    assert out is x and log == want
    assert want.count("shared") == cfg.n_shared_sites
    assert [c["from"] for c in cache] == (
        [f"layer{n}" for n in range(cfg.n_layers)]
        + ["shared"] * cfg.n_shared_sites)


def test_mamba2_weights_follow_the_jax_initialisers(jx):
    """``mamba2_init``'s shapes and types in a bf16 model (``a_log``,
    ``dt_bias``, ``d_skip`` f32), ``a_log = log(linspace(1, 16, h))``,
    ``dt_bias`` 0, ``d_skip`` 1, the conv at 0.1, and the shared block's
    names and shapes; head width 64 whatever ``cfg.hd``."""
    jax, _, jconfigs, _, _, JT = jx
    jcfg = jconfigs.get_config(ZAMBA)
    shapes = jax.eval_shape(lambda: JT.init(jcfg, jax.random.PRNGKey(0)))
    model = T.Transformer(configs.get_config(ZAMBA), device="meta")
    state = model.state_dict()
    for name, leaf in _flatten(shapes["blocks0"], "").items():
        got = state[f"layers.0.{name}"]
        assert tuple(got.shape) == leaf.shape[1:], name
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), name
    for name, leaf in _flatten(shapes["shared"], "").items():
        assert tuple(state[f"shared.{name}"].shape) == leaf.shape, name
    smoke = dataclasses.replace(configs.get_smoke(ZAMBA),
                                param_dtype="bfloat16")
    assert smoke.hd == 16
    layer = T.Transformer(smoke, device="cpu",
                          generator=torch.Generator().manual_seed(1)
                          ).layers[0]
    assert layer.head_dim == 64 and tuple(layer.a_log.shape) == (2,)
    jl = JT.init(dataclasses.replace(jconfigs.get_smoke(ZAMBA),
                                     param_dtype="bfloat16"),
                 jax.random.PRNGKey(0))["blocks0"]
    np.testing.assert_allclose(f32(layer.a_log), f32(jl["a_log"][0]),
                               rtol=1e-6, atol=1e-6)
    assert torch.all(layer.dt_bias == 0) and torch.all(layer.d_skip == 1)
    assert 0.05 < float(layer.conv.float().std()) < 0.2
    assert layer.conv.dtype == torch.bfloat16


def test_import_lm_params_loads_zamba2_strictly_keeping_types(jx):
    """JAX's stacked ``blocks0`` goes to the per-layer modules and the
    un-stacked ``shared`` tree to the shared block; every leaf keeps its
    type (f32 ``a_log``/``dt_bias``/``d_skip`` in a bf16 model)."""
    jax, _, jconfigs, _, _, JT = jx
    jcfg = dataclasses.replace(jconfigs.get_smoke(ZAMBA),
                               param_dtype="bfloat16")
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(4)))
    cfg = dataclasses.replace(configs.get_smoke(ZAMBA),
                              param_dtype="bfloat16")
    imported = import_lm_params(cfg, params)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(imported, strict=True)
    state = model.state_dict()
    assert imported.keys() == state.keys()
    assert all(imported[k].dtype == state[k].dtype for k in state)
    assert imported["layers.4.a_log"].dtype == torch.float32
    assert imported["shared.attn.wq.w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        f32(state["layers.3.in_proj.w"]),
        f32(params["blocks0"]["in_proj"]["w"][3]))
    np.testing.assert_array_equal(f32(state["shared.mlp.down.w"]),
                                  f32(params["shared"]["mlp"]["down"]["w"]))


# ------------------------------------------------- full-width structure ---

@pytest.mark.parametrize("arch", DENSE + (RWKV, ZAMBA))
def test_full_param_count_on_meta_matches_jax(arch, jx):
    _, _, jconfigs, _, _, _ = jx
    cfg = configs.get_config(arch)
    model = T.Transformer(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert len(model.layers) == cfg.n_layers
    n = cfg.param_count()
    assert n == model.param_count() == jconfigs.get_config(arch).param_count()
    assert n == FULL_PARAMS.get(arch, n)


def test_default_route_is_the_kernel_and_default_device_the_card():
    cfg = configs.get_config("qwen3-0.6b")
    assert cfg.attn_impl == "kernel" and cfg.dtype == torch.bfloat16
    assert configs.get_smoke("qwen3-0.6b").dtype == torch.float32
    assert T.Transformer(cfg, device="meta").device.type == "meta"


def test_moe_block_builds():
    """A ``moe_attn`` layer on a dense smoke config builds with the JAX
    layout: the f32 router, the stacked experts in the model's type, the
    shared MLP only with ``shared_expert``, no dense MLP."""
    for shared in (False, True):
        cfg = dataclasses.replace(
            configs.get_smoke("qwen3-0.6b"), param_dtype="bfloat16",
            pattern=(T.BlockSpec(kind="moe_attn"),), n_experts=4, top_k=2,
            shared_expert=shared)
        block = T.Transformer(cfg, device="meta").layers[0]
        assert block.mlp is None
        assert block.moe.router.w.dtype == torch.float32
        assert tuple(block.moe.router.w.shape) == (cfg.d_model, 4)
        assert tuple(block.moe.gate.shape) == (4, cfg.d_model, cfg.d_ff)
        assert tuple(block.moe.down.shape) == (4, cfg.d_ff, cfg.d_model)
        assert block.moe.up.dtype == torch.bfloat16
        assert (block.shared_mlp is not None) == shared


def test_arch_ids_equal_the_jax_packages(jx):
    _, _, jconfigs, _, _, _ = jx
    assert set(configs.arch_ids()) == set(jconfigs.arch_ids()) == set(
        DENSE) | {RWKV, ZAMBA, "mixtral-8x22b", "llama4-maverick-400b-a17b",
                  "whisper-tiny", "pixtral-12b"}


def test_unported_arch_is_a_key_error():
    """Every arch of the JAX package is ported; an id of none of them
    still raises ``KeyError``."""
    with pytest.raises(KeyError, match="not ported"):
        configs.get_config("whisper-large")
    with pytest.raises(KeyError, match="not ported"):
        configs.get_smoke("")


def test_weights_come_from_the_generator():
    cfg = configs.get_smoke("qwen1.5-4b")
    a = T.Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    b = T.Transformer(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    c = T.Transformer(cfg, device="cpu")
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.layers[0].attn.wq.w, c.layers[0].attn.wq.w)
    w = a.layers[0].mlp.down.w
    assert float(w.abs().max()) <= 2.0 / cfg.d_ff ** 0.5 + 1e-6
    assert torch.count_nonzero(a.layers[0].attn.wq.b) == 0
