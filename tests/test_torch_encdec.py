"""whisper (encoder-decoder with cross-attention) and pixtral (patch
tokens fused before the text) in the port, against the JAX package.

Weights come from the JAX package's ``init`` and are carried over with
``repro_torch.carry.import_lm_params``; token ids, patches and frames are
drawn with numpy from a seed.  Both packages then compute the same
function on the CPU, for the smoke configs of ``whisper-tiny`` and
``pixtral-12b``:

* the ``Encoder`` against ``_run_encoder`` (at the smoke's 24 frames, at
  150, and at 600, which leaves a partial key chunk of 88 behind the
  chunk of 512 in ``attention_chunked``), the cross-attention k/v against
  ``_encoder_kv`` and ``CrossAttention`` against ``_cross_attn_apply``;
* ``forward``, then ``prefill`` and three ``decode_step``s (logits and
  every cache entry; decode leaves the cross-attention entries as they
  were), in f32 at rtol/atol 1e-4 against the JAX ``"chunked"`` route
  (``tests/test_torch_models.py``'s bound), and in bf16 at rtol 2e-2 and
  ``BF16_ATOL``: 2e-2 for whisper (logits up to 0.6), 0.1 for pixtral,
  whose logits reach 3.8 (a bf16 ulp is 0.0156 there) and whose bf16
  forward, in either package, is up to 0.067 from the f32 forward of the
  same weights (measured over three seeds; the two packages 0.049 apart),
  as RWKV6's bf16 case is held in ``tests/test_torch_models.py``;
* one case per arch against the JAX ``"kernel"`` route (the Pallas kernel
  in interpret mode);
* serving: ``make_prefill_step`` with patches or frames in the batch and
  the engine's ``DecodeRunner`` (eager on the CPU) serve the tokens of
  the JAX package's jitted ``make_prefill_step``/``make_serve_step``, and
  pixtral's ``Engine.run`` (text-only, as the JAX engine serves it) the
  JAX ``Engine``'s tokens.  A token may differ only where the JAX step's
  two largest logits are closer than ``TIE_TOL``
  (``tests/test_torch_serve.py``'s rule).

The encoder and the cross-attention run ``attention_chunked`` whatever
``attn_impl`` says (a fixed route: the kernels refuse the encoder's
padded, non-causal keys).  The full-width configs are checked on
``meta`` for their parameter counts.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve import engine

WHISPER = "whisper-tiny"
PIXTRAL = "pixtral-12b"
FULL_PARAMS = {WHISPER: 36_439_680, PIXTRAL: 12_247_782_400}
TIE_TOL = 1e-4
BF16_ATOL = {WHISPER: 2e-2, PIXTRAL: 0.1}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jx():
    """``jax``, ``jax.numpy`` and the JAX package's configs, transformer
    and serve engine."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.serve import engine as jengine
    return jax, jnp, jconfigs, JT, jengine


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, jax_impl, encoder_seq):
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    change = dict(param_dtype=dtype)
    if encoder_seq:
        change["encoder_seq"] = encoder_seq
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), attn_impl=jax_impl,
                               **change)
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(2)))
    cfg = dataclasses.replace(configs.get_smoke(arch), **change)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(cfg, params), strict=True)
    return jcfg, params, model


def pair(arch, dtype="float32", jax_impl="chunked", encoder_seq=0):
    """The JAX config and weights (numpy leaves) and the port's model with
    the same weights, for ``arch``'s smoke config (``encoder_seq``, when
    given, replaces whisper's 24 frames)."""
    return _pair(arch, dtype, jax_impl, encoder_seq)


def inputs(cfg, seed, b, t):
    """Numpy ``tokens (b, t)`` and, for the arch, ``patches (b, P, d)`` or
    ``frames (b, S, d)`` (standard normal, f32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t), dtype=np.int32)}
    if cfg.patch_tokens:
        out["patches"] = rng.standard_normal(
            (b, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_jax(jnp, batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def n_cross(cfg):
    return cfg.n_layers + cfg.n_shared_sites


def assert_cache_matches(cfg, cache, jcache, tol, where=""):
    """Layer ``n``'s ``{k, v}`` against ``blocks0[n]`` and period ``p``'s
    cross-attention entry against ``enc_kv[p]``."""
    n_enc = cfg.n_periods if cfg.is_enc_dec else 0
    assert len(cache) == n_cross(cfg) + n_enc
    for n in range(cfg.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                f32(cache[n][name]), f32(jcache["blocks0"][name][n]),
                rtol=tol, atol=tol, err_msg=f"{where} layer {n} {name}")
    for p in range(n_enc):
        for name in ("k", "v"):
            got = cache[n_cross(cfg) + p][name]
            want = jcache["enc_kv"][name][p]
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(f32(got), f32(want), rtol=tol,
                                       atol=tol,
                                       err_msg=f"{where} cross {p} {name}")


# ----------------------------------------------- encoder and cross-attention

@pytest.mark.parametrize("frames", [24, 150, 600])
def test_encoder_matches_jax(frames, jx):
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(WHISPER, encoder_seq=frames)
    assert model.encoder.layers[0].impl == "chunked"
    x = inputs(jcfg, 1, 2, 4)["frames"]
    fa.LAUNCHES.clear()
    got = model.encoder(torch.from_numpy(x))
    want = JT._run_encoder(jcfg, jax.tree.map(jnp.asarray, params),
                           jnp.asarray(x))
    assert not fa.LAUNCHES
    assert tuple(got.shape) == (2, frames, jcfg.d_model)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


def test_encoder_kv_and_cross_attention_match_jax(jx):
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(WHISPER)
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    want_kv = JT._encoder_kv(jcfg, jparams, jnp.asarray(enc))
    assert len(model.cross) == jcfg.n_periods
    for p, cross in enumerate(model.cross):
        kv = cross.encoder_kv(torch.from_numpy(enc))
        for name in ("k", "v"):
            assert tuple(kv[name].shape) == (2, jcfg.encoder_seq, jcfg.n_kv,
                                             jcfg.hd)
            np.testing.assert_allclose(f32(kv[name]),
                                       f32(want_kv[name][p]), rtol=1e-5,
                                       atol=1e-5)
        got = cross(torch.from_numpy(x), kv)
        want = JT._cross_attn_apply(
            jcfg, jax.tree.map(lambda a, p=p: a[p], jparams["cross"]),
            jnp.asarray(x), jax.tree.map(lambda a, p=p: a[p], want_kv))
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_encoder_route_is_fixed_where_the_kernel_refuses():
    """With the kernel route the encoder and the cross-attention still run
    ``attention_chunked``: at 150 frames ``ops.attention`` pads the keys
    to 256 and refuses them unmasked, and the model runs all the same."""
    _, _, model = pair(WHISPER, encoder_seq=150)
    assert model.cfg.attn_impl == "kernel"
    assert all(layer.impl == "kernel" for layer in model.layers)
    assert all(layer.impl == "chunked" for layer in model.encoder.layers)
    q = torch.zeros(4, 150, 16)
    with pytest.raises(NotImplementedError, match="non-causal padded"):
        ops.attention(q, q, q, causal=False)
    batch = as_torch(inputs(model.cfg, 2, 1, 6))
    logits, _ = T.forward(model, batch)
    assert torch.isfinite(logits).all()


# --------------------------------------------------------------- whisper ---

def test_whisper_forward_matches_jax(jx):
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(WHISPER)
    batch = inputs(jcfg, 4, 2, 20)
    fa.LAUNCHES.clear()
    got, aux = T.forward(model, as_torch(batch))
    want, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                         as_jax(jnp, batch))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert tuple(got.shape) == (2, 20, jcfg.vocab)
    assert not fa.LAUNCHES                  # CPU: the plain version
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_prefill_and_decode_match_jax(arch, jx):
    """Prefill (with frames or patches), then three decode steps at
    ``length = patch_tokens + T + 1`` onwards: logits and every cache
    entry; decode reads the cross-attention entries and leaves them."""
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(arch)
    jparams = jax.tree.map(jnp.asarray, params)
    batch = inputs(jcfg, 5, 2, 20)
    prompt = dict(batch, tokens=batch["tokens"][:, :17])
    prefix = jcfg.patch_tokens
    max_len = prefix + 24
    got, cache = T.prefill(model, as_torch(prompt), max_len)
    want, jcache = JT.prefill(jcfg, jparams, as_jax(jnp, prompt), max_len)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    assert_cache_matches(model.cfg, cache, jcache, 1e-4, "prefill")
    cross = [{name: a.clone() for name, a in c.items()}
             for c in cache[n_cross(model.cfg):]]
    for i in range(17, 20):
        tok = batch["tokens"][:, i:i + 1]
        length = prefix + i + 1
        got, cache = T.decode_step(model, torch.from_numpy(tok), cache,
                                   length)
        want, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(tok),
                                      jcache, jnp.int32(length))
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch}: decode at {i}")
        assert_cache_matches(model.cfg, cache, jcache, 1e-4, f"decode {i}")
    for c, before in zip(cache[n_cross(model.cfg):], cross):
        assert all(torch.equal(c[name], before[name]) for name in c)


def test_whisper_cache_layout_and_decoding_from_an_empty_cache():
    """``init_cache`` holds the layers' k/v, then one ``(B, encoder_seq,
    n_kv, hd)`` entry a period; with those filled from the encoder, token
    by token decode gives the full forward's logits."""
    _, _, model = pair(WHISPER)
    cfg = model.cfg
    batch = configs.smoke_batch(cfg, batch=2, seq=12, train=False, seed=6,
                                device="cpu")
    full, _ = T.forward(model, batch)
    cache = T.init_cache(cfg, 2, 12, device="cpu")
    assert len(cache) == cfg.n_layers + cfg.n_periods
    assert all(tuple(c["k"].shape) == (2, 12, cfg.n_kv, cfg.hd)
               for c in cache[:cfg.n_layers])
    assert all(tuple(c["v"].shape) == (2, cfg.encoder_seq, cfg.n_kv, cfg.hd)
               for c in cache[cfg.n_layers:])
    for c, kv in zip(cache[cfg.n_layers:], T._encoder_kv(model, batch)):
        for name in c:
            c[name].copy_(kv[name])
    for i in range(12):
        got, cache = T.decode_step(model, batch["tokens"][:, i:i + 1], cache,
                                   i + 1)
        torch.testing.assert_close(got[:, 0], full[:, i], rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------- pixtral ---

def test_pixtral_forward_with_patches_matches_jax(jx):
    """Patches prepended, positions over the fused sequence, only the text
    positions' logits returned; without patches the text alone."""
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(PIXTRAL)
    jparams = jax.tree.map(jnp.asarray, params)
    batch = inputs(jcfg, 7, 2, 16)
    got, _ = T.forward(model, as_torch(batch))
    want, _ = JT.forward(jcfg, jparams, as_jax(jnp, batch))
    assert tuple(got.shape) == (2, 16, jcfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    text = {"tokens": batch["tokens"]}
    got_text, _ = T.forward(model, as_torch(text))
    want_text, _ = JT.forward(jcfg, jparams, as_jax(jnp, text))
    np.testing.assert_allclose(f32(got_text), f32(want_text), rtol=1e-4,
                               atol=1e-4)
    assert float((got_text - got).abs().max()) > 1e-2   # the patches count


# --------------------------------------------------------- both, routes ---

@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_forward_matches_jax_pallas_kernel_route(arch, jx):
    """The JAX package's ``attn_impl="kernel"`` (the Pallas flash kernel
    in interpret mode, for whisper's encoder too) against the port's
    kernel route (its plain version here; the encoder chunked)."""
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(arch, jax_impl="kernel")
    assert model.cfg.attn_impl == "kernel"
    batch = inputs(jcfg, 8, 1, 24)
    got, _ = T.forward(model, as_torch(batch))
    want, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, params),
                         as_jax(jnp, batch))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_bf16_forward_and_decode_match_jax(arch, jx):
    jax, jnp, _, JT, _ = jx
    jcfg, params, model = pair(arch, dtype="bfloat16")
    assert model.embed.table.dtype == torch.bfloat16
    jparams = jax.tree.map(jnp.asarray, params)
    batch = inputs(jcfg, 9, 2, 16)
    got, _ = T.forward(model, as_torch(batch))
    want, _ = JT.forward(jcfg, jparams, as_jax(jnp, batch))
    tol = dict(rtol=2e-2, atol=BF16_ATOL[arch])
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    prompt = dict(batch, tokens=batch["tokens"][:, :15])
    max_len = jcfg.patch_tokens + 16
    _, cache = T.prefill(model, as_torch(prompt), max_len)
    _, jcache = JT.prefill(jcfg, jparams, as_jax(jnp, prompt), max_len)
    assert cache[-1]["k"].dtype == torch.bfloat16
    tok = batch["tokens"][:, 15:]
    got, _ = T.decode_step(model, torch.from_numpy(tok), cache, max_len)
    want, _ = JT.decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                             jnp.int32(max_len))
    np.testing.assert_allclose(f32(got), f32(want), **tol)


# ----------------------------------------------------------- structure ---

@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL, "qwen3-0.6b"])
def test_smoke_batch_keys_and_shapes_equal_jax(arch, jx):
    _, _, jconfigs, _, _ = jx
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    for train in (False, True):
        got = configs.smoke_batch(cfg, batch=3, seq=20, train=train, seed=4,
                                  device="cpu")
        want = jconfigs.smoke_batch(jcfg, batch=3, seq=20, train=train,
                                    seed=4)
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            assert tuple(got[key].shape) == val.shape, key
            assert str(got[key].dtype).split(".")[-1] == str(val.dtype), key
    again = configs.smoke_batch(cfg, batch=3, seq=20, seed=4, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_full_param_count_on_meta_matches_jax(arch, jx):
    _, _, jconfigs, _, _ = jx
    cfg = configs.get_config(arch)
    model = T.Transformer(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert len(model.layers) == cfg.n_layers
    assert model.param_count() == cfg.param_count() == \
        jconfigs.get_config(arch).param_count() == FULL_PARAMS[arch]
    assert cfg.is_enc_dec == (arch == WHISPER)
    if arch == WHISPER:
        assert len(model.encoder.layers) == cfg.encoder_layers == 4
        assert len(model.cross) == cfg.n_periods


def test_import_lm_params_names_the_encoder_and_cross_trees(jx):
    """JAX's ``encoder.blocks`` (stacked) become ``encoder.layers.{n}``,
    ``encoder.norm`` stays, ``cross`` (stacked) becomes ``cross.{p}``."""
    _, _, model = pair(WHISPER)
    jcfg, params, _ = pair(WHISPER)
    state = import_lm_params(model.cfg, params)
    assert state.keys() == model.state_dict().keys()
    np.testing.assert_array_equal(
        f32(state["encoder.layers.1.attn.wk.w"]),
        f32(params["encoder"]["blocks"]["attn"]["wk"]["w"][1]))
    np.testing.assert_array_equal(f32(state["encoder.norm.scale"]),
                                  f32(params["encoder"]["norm"]["scale"]))
    np.testing.assert_array_equal(
        f32(state["cross.1.attn.wv.w"]),
        f32(params["cross"]["attn"]["wv"]["w"][1]))
    np.testing.assert_array_equal(f32(state["cross.0.ln.scale"]),
                                  f32(params["cross"]["ln"]["scale"][0]))


# --------------------------------------------------------------- serving ---

def top_two_gap(logits):
    a, b = np.sort(logits)[-2:]
    return float(b - a)


def positions(request):
    """The positions a request's prefill fills: its patches and tokens."""
    return sum(request[k].shape[1] for k in ("patches", "tokens")
               if k in request)


def jax_serve(jx, jcfg, params, requests, max_new, slots, max_len):
    """The JAX package's jitted ``make_prefill_step`` and
    ``make_serve_step`` in ``Engine.run``'s batching, each request's batch
    carrying its patches or frames: ``{rid: [(token, logits)]}``."""
    jax, jnp, _, JT, jengine = jx
    prefill = jax.jit(jengine.make_prefill_step(jcfg, max_len))
    step = jax.jit(jengine.make_serve_step(jcfg))
    decode = jax.jit(lambda p, t, c, n: JT.decode_step(jcfg, p, t, c, n))
    out = {}
    for b0 in range(0, len(requests), slots):
        active = list(enumerate(requests))[b0:b0 + slots]
        caches, toks = [], []
        for rid, req in active:
            tok, cache = prefill(params, as_jax(jnp, req))
            out[rid] = [(int(tok[0, 0]), None)]
            caches.append(cache)
            toks.append(tok)
        cache = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=1),
                             *caches) if len(caches) > 1 else caches[0]
        toks = jnp.concatenate(toks, axis=0)
        length = max(positions(r) for _, r in active) + 1
        for _ in range(max_new - 1):
            logits, _ = decode(params, toks, cache, jnp.int32(length))
            toks, cache = step(params, toks, cache, jnp.int32(length))
            length += 1
            for i, (rid, _) in enumerate(active):
                out[rid].append((int(toks[i, 0]), np.asarray(logits[i, -1])))
    return out


def port_serve(model, requests, max_new, slots, max_len):
    """The port's ``make_prefill_step`` and the engine's ``DecodeRunner``
    (eager on the CPU) in the same batching: ``{rid: [token]}``."""
    prefill = engine.make_prefill_step(model, max_len)
    out = {}
    for b0 in range(0, len(requests), slots):
        active = list(enumerate(requests))[b0:b0 + slots]
        caches, toks = [], []
        for rid, req in active:
            tok, cache = prefill(as_torch(req))
            out[rid] = [int(tok[0, 0])]
            caches.append(cache)
            toks.append(tok)
        runner = engine.DecodeRunner(model, len(active), max_len,
                                     graphs=False)
        runner.load(caches, torch.cat(toks),
                    max(positions(r) for _, r in active) + 1)
        for _ in range(max_new - 1):
            host = runner.step()[:, 0].tolist()
            for i, (rid, _) in enumerate(active):
                out[rid].append(host[i])
    return out


def assert_serves(arch, got, traced):
    """``got`` equals ``traced``'s tokens up to the first near-tie."""
    assert sorted(got) == sorted(traced)
    for rid, served in got.items():
        for i, (tok, (jtok, logits)) in enumerate(zip(served, traced[rid])):
            if tok == jtok:
                continue
            gap = top_two_gap(logits) if logits is not None else 0.0
            assert logits is not None and gap < TIE_TOL, (
                f"{arch} request {rid} token {i}: port {tok}, JAX {jtok}, "
                f"top-two gap {gap}")
            break


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_step_entry_points_serve_the_jax_steps_tokens(arch, jx):
    """Five requests (two rounds of two slots and one of one), each with
    its own patches or frames."""
    jcfg, params, model = pair(arch)
    requests = [{k: v[:1] for k, v in inputs(jcfg, 20 + i, 1, 10).items()}
                for i in range(5)]
    max_new, slots = 5, 2
    max_len = jcfg.patch_tokens + 10 + max_new + 1
    traced = jax_serve(jx, jcfg, params, requests, max_new, slots, max_len)
    fa.LAUNCHES.clear()
    got = port_serve(model, requests, max_new, slots, max_len)
    assert not fa.LAUNCHES
    assert all(len(v) == max_new for v in got.values())
    assert_serves(arch, got, traced)


def test_pixtral_engine_serves_the_jax_engines_tokens_text_only(jx):
    jax, jnp, _, JT, jengine = jx
    jcfg, params, model = pair(PIXTRAL)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab, (n,), dtype=np.int32)
               for n in (12, 12, 9, 12)]
    max_new, slots, max_len = 5, 2, 12 + 5 + 1
    jeng = jengine.Engine(jcfg, jax.tree.map(jnp.asarray, params),
                          slots=slots, max_len=max_len)
    eng = engine.Engine(model, slots=slots, max_len=max_len)
    for rid, pr in enumerate(prompts):
        jeng.submit(jengine.Request(rid=rid, prompt=pr, max_new=max_new))
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=max_new))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    traced = jax_serve(jx, jcfg, params,
                       [{"tokens": pr[None]} for pr in prompts], max_new,
                       slots, max_len)
    assert {rid: [t for t, _ in v] for rid, v in traced.items()} == want
    assert_serves(PIXTRAL, got, traced)


def test_encdec_serving_leaves_jax_and_repro_unimported():
    """whisper with frames and pixtral with patches through the step
    entry points in a fresh interpreter: neither ``jax`` nor ``repro`` is
    imported."""
    code = (
        "import sys, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.serve import engine\n"
        "for arch in ('whisper-tiny', 'pixtral-12b'):\n"
        "    cfg = configs.get_smoke(arch)\n"
        "    model = T.Transformer(cfg, device='cpu')\n"
        "    batch = configs.smoke_batch(cfg, batch=1, seq=cfg.patch_tokens\n"
        "                                + 6, train=False, device='cpu')\n"
        "    max_len = cfg.patch_tokens + 6 + 4\n"
        "    tok, cache = engine.make_prefill_step(model, max_len)(batch)\n"
        "    run = engine.DecodeRunner(model, 1, max_len, graphs=False)\n"
        "    run.load([cache], tok, cfg.patch_tokens + 7)\n"
        "    assert run.step().shape == (1, 1)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------------------ card ---

@pytest.mark.gpu
@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_encdec_on_the_card(arch):
    """The smoke config in bf16 on the card with a padded encoder (150
    frames): the decoder's prefill launches the flash kernel (the
    encoder none), and the captured decode step serves the eager
    tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    change = dict(param_dtype="bfloat16")
    if arch == WHISPER:
        change["encoder_seq"] = 150
    cfg = dataclasses.replace(configs.get_smoke(arch), **change)
    model = T.Transformer(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    batch = configs.smoke_batch(cfg, batch=1, seq=cfg.patch_tokens + 24,
                                train=False, seed=1, device="cuda")
    max_len = cfg.patch_tokens + 24 + 6
    fa.LAUNCHES.clear()
    fa.SHAPES.clear()
    tok, cache = engine.make_prefill_step(model, max_len)(batch)
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    t = cfg.patch_tokens + 24
    assert all(key[2] == t for key in fa.SHAPES)
    tokens = {}
    for graphs in (True, False):
        run = engine.DecodeRunner(model, 1, max_len, graphs=graphs)
        run.load([cache], tok, t + 1)
        tokens[graphs] = [int(run.step()[0, 0]) for _ in range(4)]
    assert tokens[True] == tokens[False]
