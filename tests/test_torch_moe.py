"""The port's MoE against the JAX package's.

``repro_torch.models.moe.moe_apply`` is held to ``repro.models.moe.
moe_apply`` on the same weights (``moe_init``'s, as numpy) and the same
numpy tokens: both dispatch forms, top 1 and top 2, token counts that
snap the group size (a prime count, odd decode batches), capacity
overflow (tokens dropped) and all-equal probabilities (a zero router,
where ``jax.lax.top_k`` takes the lower experts first).  Out and aux in
f32 at rtol/atol 1e-5, and in bf16 at the models' bf16 bound (rtol/atol
2e-2, ``tests/test_torch_models.py``).  The mixtral and llama4 smoke
configs (weights from JAX's ``init`` through ``import_lm_params``) are
held as the dense models are: ``forward`` logits and aux, ``prefill`` and
``decode_step`` in f32 at 1e-4, on the kernel route (its plain version on
the CPU) and the chunked route; the full configs' parameter counts on
``meta``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

MIXTRAL = "mixtral-8x22b"
LLAMA4 = "llama4-maverick-400b-a17b"
MOE_ARCHS = (MIXTRAL, LLAMA4)
FULL_PARAMS = {MIXTRAL: (140_630_071_296, 39_161_468_928),
               LLAMA4: (397_691_950_080, 14_164_792_320)}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import moe as JM
    from repro.models import transformer as JT
    return jax, jnp, jconfigs, JM, JT


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def moe_pair(jx, d, ff, e, dtype="float32", seed=0, zero_router=False):
    """``moe_init``'s weights as numpy and the port's MoE module on them."""
    jax, jnp, _, JM, _ = jx
    p = jax.tree.map(np.asarray, JM.moe_init(
        jax.random.PRNGKey(seed), d, ff, e, getattr(jnp, dtype)))
    if zero_router:
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    mod = M.MoE(d, ff, e, dtype=getattr(torch, dtype), device="cpu",
                generator=None)
    mod.load_state_dict({"router.w": to_torch(p["router"]["w"]),
                         "gate": to_torch(p["gate"]), "up": to_torch(p["up"]),
                         "down": to_torch(p["down"])}, strict=True)
    return p, mod


def tokens_x(seed, b, t, d, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype)), x


#: (b, t, d, ff, E, group_size, capacity_factor): a group that divides the
#: tokens, a prime count (23 tokens: the group snaps to 1), an odd one (21
#: tokens at 8: groups of 7), decode batches of 3 and 4 tokens, and an
#: overflowing capacity (16 tokens of top 2 over 4 experts at cf 0.5: 4
#: slots an expert).
APPLY_CASES = [
    (2, 16, 16, 24, 4, 16, 1.25),
    (1, 23, 16, 24, 4, 16, 1.25),
    (3, 7, 16, 24, 4, 8, 1.25),
    (3, 1, 16, 24, 4, 512, 1.25),
    (4, 1, 16, 24, 8, 512, 1.25),
    (2, 16, 16, 24, 4, 16, 0.5),
]


@pytest.mark.parametrize("case", APPLY_CASES, ids=str)
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_apply_matches_jax(case, top_k, dispatch, jx):
    jax, jnp, _, JM, _ = jx
    b, t, d, ff, e, gs, cf = case
    p, mod = moe_pair(jx, d, ff, e)
    x, xn = tokens_x(1, b, t, d)
    kw = dict(top_k=top_k, capacity_factor=cf, group_size=gs,
              dispatch=dispatch)
    got, aux = M.moe_apply(mod, x, **kw)
    want, jaux = JM.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(xn),
                              **kw)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


def test_overflow_case_drops_tokens():
    """The overflowing case of :data:`APPLY_CASES` does drop: some
    (token, choice) lands past its expert's 4 slots."""
    b, t, d, ff, e, gs, cf = APPLY_CASES[-1]
    cap = M.capacity_of(M.snap_group_size(b * t, gs), 2, e, cf)
    assert cap == 4 and b * t * 2 > e * cap


def test_group_size_snaps_and_capacity_as_jax():
    assert M.snap_group_size(23, 16) == 1
    assert M.snap_group_size(21, 8) == 7
    assert M.snap_group_size(3, 512) == 3
    assert M.snap_group_size(543, 512) == 181
    assert M.capacity_of(512, 2, 8, 1.25) == 160
    assert M.capacity_of(4, 2, 8, 1.25) == 4          # the floor of 4
    assert M.capacity_of(181, 2, 8, 1.25) == 57


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_tied_probabilities_break_like_lax_top_k(top_k, dispatch, jx):
    """A zero router gives every expert 1/E: the top k are the lowest
    experts, in order, so the cumsum fills their slots in token order and
    the overflow drops the last tokens, as in JAX."""
    jax, jnp, _, JM, _ = jx
    p, mod = moe_pair(jx, 16, 24, 4, zero_router=True)
    x, xn = tokens_x(2, 2, 16, 16)
    probs = torch.full((1, 5, 4), 0.25)
    vals, idx = M.top_k_stable(probs, top_k)
    assert idx.tolist() == [[list(range(top_k))] * 5]
    kw = dict(top_k=top_k, capacity_factor=1.0, group_size=16,
              dispatch=dispatch)
    got, aux = M.moe_apply(mod, x, **kw)
    want, jaux = JM.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(xn),
                              **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)
    # capacity ceil(16·k/4) = 4k of 16 tokens: the first 4k keep their
    # experts' output, the rest get nothing
    kept = 4 * top_k
    assert torch.count_nonzero(got[:, kept:]) == 0
    assert torch.all(got[:, :kept].abs().sum(-1) > 0)


@pytest.mark.parametrize("case", APPLY_CASES, ids=str)
def test_einsum_and_scatter_forms_are_equal(case, jx):
    b, t, d, ff, e, gs, cf = case
    _, mod = moe_pair(jx, d, ff, e, seed=3)
    x, _ = tokens_x(4, b, t, d)
    outs = {disp: M.moe_apply(mod, x, top_k=2, capacity_factor=cf,
                              group_size=gs, dispatch=disp)
            for disp in M.DISPATCHES}
    torch.testing.assert_close(outs["einsum"][0], outs["scatter"][0],
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(outs["einsum"][1], outs["scatter"][1])


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_bf16_moe_apply_matches_jax(dispatch, jx):
    """bf16 weights and tokens: the router f32, the products f32 against
    the bf16 experts, the output cast to bf16, as in JAX."""
    jax, jnp, _, JM, _ = jx
    p, mod = moe_pair(jx, 16, 24, 4, dtype="bfloat16")
    assert mod.router.w.dtype == torch.float32
    assert mod.gate.dtype == torch.bfloat16
    x, xn = tokens_x(5, 2, 16, 16, dtype="bfloat16")
    kw = dict(top_k=2, capacity_factor=1.25, group_size=16,
              dispatch=dispatch)
    got, aux = M.moe_apply(mod, x, **kw)
    want, jaux = JM.moe_apply(jax.tree.map(jnp.asarray, p),
                              jnp.asarray(xn, jnp.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-2, atol=2e-2)


def test_unknown_dispatch_raises(jx):
    _, mod = moe_pair(jx, 16, 24, 4)
    with pytest.raises(ValueError, match="dispatch"):
        M.moe_apply(mod, torch.zeros(1, 4, 16), top_k=1, dispatch="ragged")


# ---------------------------------------------------------------- models ---

@functools.lru_cache(maxsize=None)
def _model_pair(arch, dtype, impl, seed):
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), param_dtype=dtype)
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(seed)))
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype=dtype,
                              attn_impl=impl)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(cfg, params), strict=True)
    return jcfg, params, model


def model_pair(arch, dtype="float32", impl="kernel", seed=0):
    return _model_pair(arch, dtype, impl, seed)


def tokens(cfg, seed, b, t):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t),
                                                dtype=np.int32)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, impl, jx):
    jax, jnp, _, _, JT = jx
    jcfg, params, model = model_pair(arch, impl=impl)
    toks = tokens(jcfg, 1, 2, 24)
    got, aux = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, jaux = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                            {"tokens": jnp.asarray(toks)})
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert float(aux) > 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch, impl, jx):
    """Prefill (logits and every layer's k/v), then decode steps of a
    batch of 3 (an odd decode group), at 1e-4."""
    jax, jnp, _, _, JT = jx
    jcfg, params, model = model_pair(arch, impl=impl)
    jparams = jax.tree.map(jnp.asarray, params)
    toks = tokens(jcfg, 2, 3, 20)
    max_len = 24
    got, cache = T.prefill(model, {"tokens": torch.from_numpy(toks[:, :17])},
                           max_len)
    want, jcache = JT.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(toks[:, :17])}, max_len)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    n_pat = len(jcfg.pattern)
    for n, c in enumerate(cache):
        jc = jcache[f"blocks{n % n_pat}"]
        for name in ("k", "v"):
            np.testing.assert_allclose(f32(c[name]), f32(jc[name][n // n_pat]),
                                       rtol=1e-4, atol=1e-4)
    for i in range(17, 20):
        tok = toks[:, i:i + 1]
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache, i + 1)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                                      jnp.int32(i + 1))
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch}: decode at {i}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decoding_from_an_empty_cache_matches_forward(arch):
    """Token by token from ``init_cache`` the logits are the full
    forward's: the smoke configs' capacity (cf 4 at top 2, cf 8 at top 1,
    over 4 experts) never drops a token, however the tokens group."""
    _, _, model = model_pair(arch)
    batch = configs.smoke_batch(model.cfg, batch=2, seq=12, train=False,
                                seed=6, device="cpu")
    full, _ = T.forward(model, batch)
    cache = T.init_cache(model.cfg, 2, 12, device="cpu")
    for i in range(12):
        got, cache = T.decode_step(model, batch["tokens"][:, i:i + 1], cache,
                                   i + 1)
        torch.testing.assert_close(got[:, 0], full[:, i], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_kernel_route_equals_chunked_route(arch):
    _, _, kernel = model_pair(arch, impl="kernel")
    _, _, chunked = model_pair(arch, impl="chunked")
    toks = torch.from_numpy(tokens(kernel.cfg, 7, 2, 30))
    a, aux_a = T.forward(kernel, {"tokens": toks})
    b, aux_b = T.forward(chunked, {"tokens": toks})
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux_a, aux_b, rtol=1e-6, atol=1e-6)


def test_mixtral_bf16_forward_matches_jax(jx):
    """bf16 weights: the router and the expert products in f32, as in
    JAX, at the models' bf16 bound."""
    jax, jnp, _, _, JT = jx
    jcfg, params, model = model_pair(MIXTRAL, dtype="bfloat16")
    layer = model.layers[0]
    assert layer.moe.router.w.dtype == torch.float32
    assert layer.moe.gate.dtype == torch.bfloat16
    toks = tokens(jcfg, 8, 2, 16)
    got, aux = T.forward(model, {"tokens": torch.from_numpy(toks)})
    want, jaux = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                            {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_full_param_counts_on_meta_match_jax(arch, jx):
    _, _, jconfigs, _, _ = jx
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    model = T.Transformer(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    total, active = FULL_PARAMS[arch]
    assert cfg.param_count() == model.param_count() == jcfg.param_count() \
        == total
    assert cfg.active_param_count() == jcfg.active_param_count() == active
    smoke, jsmoke = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    assert smoke.param_count() == jsmoke.param_count()
    assert smoke.active_param_count() == jsmoke.active_param_count()


def test_dense_active_param_count_is_the_param_count(jx):
    _, _, jconfigs, _, _ = jx
    cfg = configs.get_smoke("qwen3-0.6b")
    assert cfg.active_param_count() == cfg.param_count() == \
        jconfigs.get_smoke("qwen3-0.6b").active_param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_import_lm_params_loads_moe_smokes_strictly_keeping_types(arch, jx):
    """In a bf16 model: the router f32, the stacked experts bf16 at JAX's
    layout, llama4's shared MLP beside them; every leaf equal."""
    jcfg, params, model = model_pair(arch, dtype="bfloat16")
    state = import_lm_params(model.cfg, params)
    n_pat = len(jcfg.pattern)
    moe_layers = [n for n in range(jcfg.n_layers)
                  if jcfg.pattern[n % n_pat].kind == "moe_attn"]
    assert moe_layers
    e, d, ff = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    for n in moe_layers:
        i, p = n % n_pat, n // n_pat
        jp = params[f"blocks{i}"]
        assert state[f"layers.{n}.moe.router.w"].dtype == torch.float32
        for name, shape in (("gate", (e, d, ff)), ("up", (e, d, ff)),
                            ("down", (e, ff, d))):
            t = state[f"layers.{n}.moe.{name}"]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == shape
            np.testing.assert_array_equal(f32(t), f32(jp["moe"][name][p]))
        has_shared = f"layers.{n}.shared_mlp.gate.w" in state
        assert has_shared == jcfg.shared_expert
        if has_shared:
            np.testing.assert_array_equal(
                f32(state[f"layers.{n}.shared_mlp.down.w"]),
                f32(jp["shared_mlp"]["down"]["w"][p]))
    assert set(state) == set(model.state_dict())
