"""The port's serving engine against the JAX package's.

The same weights (``repro_torch.carry.import_lm_params``) and the same
numpy prompts go through ``repro.serve.engine.Engine`` and the port's
``Engine`` on the CPU (the dense archs, RWKV6, zamba2 and the MoE archs),
with prompts of equal and of unequal length.  The served tokens must be equal, except that a token may differ where the JAX
step's two largest logits are closer than ``TIE_TOL`` (the port's and the
JAX package's logits agree to 1e-4, ``tests/test_torch_models.py``); such
a token is reported as a warning, and the request's later tokens, which
follow from it, are not compared.  The JAX step's logits come from a copy
of the JAX engine's loop that keeps them, checked to serve the JAX
``Engine``'s own tokens.
"""
import dataclasses
import io
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_attn as la
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import engine

TIE_TOL = 1e-4

PROMPT_LENGTHS = {"equal": (12, 12, 12, 12, 12), "unequal": (9, 14, 6, 11, 3)}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.serve import engine as jengine
    return jax, jnp, jconfigs, JT, jengine


def prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,), dtype=np.int32)
            for n in lengths]


def jax_engine_logits(jx, jcfg, params, prompt_list, max_new, slots,
                      max_len):
    """``repro.serve.engine.Engine.run``'s loop with the JAX package's own
    steps, keeping the logits each served token was taken from:
    ``{rid: [(token, logits)]}``."""
    jax, jnp, _, JT, _ = jx
    prefill = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, max_len=max_len))
    step = jax.jit(lambda p, t, c, n: JT.decode_step(jcfg, p, t, c, n))
    queue = list(enumerate(prompt_list))
    out = {}
    while queue:
        active, queue = queue[:slots], queue[slots:]
        caches, toks = [], []
        for rid, pr in active:
            logits, cache = prefill(params, {"tokens": jnp.asarray(pr)[None]})
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            out[rid] = [(int(tok[0, 0]), np.asarray(logits[0, -1]))]
            caches.append(cache)
            toks.append(tok)
        cache = jax.tree.map(lambda *ls: jnp.concatenate(ls, axis=1),
                             *caches) if len(caches) > 1 else caches[0]
        toks = jnp.concatenate(toks, axis=0)
        length = max(len(pr) for _, pr in active) + 1
        for _ in range(max_new - 1):
            logits, cache = step(params, toks, cache, jnp.int32(length))
            toks = jnp.argmax(logits[:, -1], axis=-1).astype(
                jnp.int32)[:, None]
            length += 1
            for i, (rid, _) in enumerate(active):
                out[rid].append((int(toks[i, 0]), np.asarray(logits[i, -1])))
    return out


def top_two_gap(logits):
    a, b = np.sort(logits)[-2:]
    return float(b - a)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("lengths", sorted(PROMPT_LENGTHS))
def test_engine_serves_the_jax_engines_tokens(arch, lengths, jx):
    jax, jnp, jconfigs, JT, jengine = jx
    jcfg = jconfigs.get_smoke(arch)
    params = JT.init(jcfg, jax.random.PRNGKey(1))
    cfg = configs.get_smoke(arch)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(
        cfg, jax.tree.map(np.asarray, params)))
    prompt_list = prompts(cfg.vocab, PROMPT_LENGTHS[lengths])
    max_new, slots = 6, 2
    max_len = max(PROMPT_LENGTHS[lengths]) + max_new + 1

    jeng = jengine.Engine(jcfg, params, slots=slots, max_len=max_len)
    eng = engine.Engine(model, slots=slots, max_len=max_len)
    for rid, pr in enumerate(prompt_list):
        jeng.submit(jengine.Request(rid=rid, prompt=pr, max_new=max_new))
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=max_new))
    want = {r.rid: r.out for r in jeng.run()}
    fa.LAUNCHES.clear()
    done = eng.run()
    assert not fa.LAUNCHES                   # CPU: the plain version
    got = {r.rid: r.out for r in done}
    assert sorted(got) == sorted(want) == list(range(len(prompt_list)))
    assert all(r.done and len(r.out) == max_new for r in done)

    traced = jax_engine_logits(jx, jcfg, params, prompt_list, max_new, slots,
                               max_len)
    assert {rid: [t for t, _ in v] for rid, v in traced.items()} == want
    for rid, served in got.items():
        for i, (tok, (jtok, logits)) in enumerate(zip(served, traced[rid])):
            if tok == jtok:
                continue
            gap = top_two_gap(logits)
            assert gap < TIE_TOL, (
                f"{arch} request {rid} token {i}: port {tok}, JAX {jtok}, "
                f"JAX top-two gap {gap}")
            warnings.warn(f"{arch} request {rid} token {i}: port {tok}, JAX "
                          f"{jtok} at a near-tie (top-two gap {gap})")
            break

    stats = eng.stats
    assert stats.prefill_tokens == sum(PROMPT_LENGTHS[lengths])
    assert stats.decode_steps == 3 * (max_new - 1)     # 3 rounds of 2 slots
    assert stats.prefill_s > 0 and stats.decode_s > 0


def test_rwkv6_requests_decode_as_if_served_alone():
    """An RWKV6 state carries no positions: with prompts of unequal length
    in one batch, every request gets the tokens it gets alone (one slot),
    and the batched caches hold each layer's ``{wkv, shift1, shift2}``."""
    cfg = configs.get_smoke("rwkv6-1.6b")
    model = T.Transformer(cfg, device="cpu")
    prompt_list = prompts(cfg.vocab, PROMPT_LENGTHS["unequal"], seed=3)
    out = {}
    for slots in (1, 5):
        eng = engine.Engine(model, slots=slots, max_len=24)
        for rid, pr in enumerate(prompt_list):
            eng.submit(engine.Request(rid=rid, prompt=pr, max_new=6))
        out[slots] = {r.rid: r.out for r in eng.run()}
    assert out[5] == out[1]
    prefill = engine.make_prefill_step(model, 24)
    _, cache = prefill({"tokens": torch.from_numpy(prompt_list[0])[None]})
    assert [sorted(c) for c in cache] == [["shift1", "shift2", "wkv"]] * \
        cfg.n_layers


def test_rwkv6_engine_matches_teacher_forced_forward():
    """``examples/serve_e2e.py``'s self-check on RWKV6: the served tokens
    are the greedy tokens of a full forward (prefill through the kernel
    route, decode through the recurrence)."""
    cfg = configs.get_smoke("rwkv6-1.6b")
    assert cfg.attn_impl == "kernel"
    model = T.Transformer(cfg, device="cpu")
    eng = engine.Engine(model, slots=2, max_len=40)
    for rid, pr in enumerate(prompts(cfg.vocab, (20, 13, 20), seed=5)):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=6))
    la.LAUNCHES.clear()
    for r in eng.run():
        seq = torch.from_numpy(np.concatenate([r.prompt, r.out[:-1]]))[None]
        logits, _ = T.forward(model, {"tokens": seq.int()})
        served = torch.tensor(r.out)
        pos = logits[0, len(r.prompt) - 1:]
        picked = pos.gather(1, served[:, None])[:, 0]
        assert torch.all(pos.amax(1) - picked <= 1e-5), r.rid
    assert not la.LAUNCHES                   # CPU: the plain version


def test_serve_step_writes_the_cache_in_place():
    cfg = configs.get_smoke("qwen3-4b")
    model = T.Transformer(cfg, device="cpu")
    prefill = engine.make_prefill_step(model, 12)
    step = engine.make_serve_step(model)
    toks = torch.from_numpy(prompts(cfg.vocab, (8,))[0])[None]
    tok, cache = prefill({"tokens": toks})
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (1, 1)
    assert torch.count_nonzero(cache[0]["k"][:, 8:]) == 0
    nxt, cache2 = step(tok, cache, 9)
    assert cache2 is cache
    assert torch.count_nonzero(cache[0]["k"][:, 8]) > 0
    assert torch.count_nonzero(cache[0]["k"][:, 9:]) == 0
    full, _ = T.forward(model, {"tokens": torch.cat([toks, tok], 1)})
    assert int(nxt) == int(torch.argmax(full[0, -1]))


def test_engine_matches_teacher_forced_forward_on_the_kernel_route():
    """``examples/serve_e2e.py``'s self-check on the port: the served
    tokens are the greedy tokens of a full forward (equal prompt lengths,
    so no shifted positions)."""
    cfg = configs.get_smoke("gemma2-2b")
    assert cfg.attn_impl == "kernel"
    model = T.Transformer(cfg, device="cpu")
    eng = engine.Engine(model, slots=2, max_len=32)
    for rid, pr in enumerate(prompts(cfg.vocab, (12,) * 3, seed=5)):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=6))
    for r in eng.run():
        seq = torch.from_numpy(np.concatenate([r.prompt, r.out[:-1]]))[None]
        logits, _ = T.forward(model, {"tokens": seq.int()})
        served = torch.tensor(r.out)
        pos = logits[0, len(r.prompt) - 1:]
        picked = pos.gather(1, served[:, None])[:, 0]
        assert torch.all(pos.amax(1) - picked <= 1e-5), r.rid


def test_launcher_serves_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_serve.main(["--device", "cpu", "--requests", "3",
                                "--prompt-len", "5", "--max-new", "3",
                                "--slots", "2", "--arch", "qwen1.5-4b"])
    text = buf.getvalue()
    assert rc == 0
    assert "served 3 requests, 9 tokens" in text
    assert "device=cpu attn_impl=kernel" in text


def test_launcher_serves_rwkv6_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_serve.main(["--device", "cpu", "--requests", "3",
                                "--prompt-len", "5", "--max-new", "3",
                                "--slots", "2", "--arch", "rwkv6-1.6b"])
    text = buf.getvalue()
    assert rc == 0
    assert "arch=rwkv6-1.6b-smoke device=cpu attn_impl=kernel" in text
    assert "served 3 requests, 9 tokens" in text


def test_launcher_serves_zamba2_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_serve.main(["--device", "cpu", "--requests", "3",
                                "--prompt-len", "5", "--max-new", "3",
                                "--slots", "2", "--arch", "zamba2-1.2b"])
    text = buf.getvalue()
    assert rc == 0
    assert "arch=zamba2-1.2b-smoke device=cpu attn_impl=kernel" in text
    assert "served 3 requests, 9 tokens" in text


def test_launcher_serves_mixtral_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_serve.main(["--device", "cpu", "--requests", "3",
                                "--prompt-len", "5", "--max-new", "3",
                                "--slots", "2", "--arch", "mixtral-8x22b"])
    text = buf.getvalue()
    assert rc == 0
    assert "arch=mixtral-8x22b-smoke device=cpu attn_impl=kernel" in text
    assert "served 3 requests, 9 tokens" in text


def test_engine_on_the_card_needs_a_card(monkeypatch):
    from repro_torch import DeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        launch_serve.main(["--device", "cuda", "--requests", "1"])


def test_bf16_engine_serves_whole_requests():
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              param_dtype="bfloat16")
    eng = engine.Engine(T.Transformer(cfg, device="cpu"), slots=3,
                        max_len=20)
    for rid, pr in enumerate(prompts(cfg.vocab, (7, 10, 4, 9))):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=5))
    done = eng.run()
    assert [r.rid for r in done] == [0, 1, 2, 3]
    assert all(len(r.out) == 5 and all(0 <= t < cfg.vocab for t in r.out)
               for r in done)


def card_kernels(cfg):
    """The kernels a prefill of ``cfg`` launches on the card: (wrapper
    module, launch key, launches a prefill) — flash attention once an
    attention layer (dense or MoE) or shared site, linear attention once
    a recurrent layer."""
    if cfg.pattern[0].kind in ("attn", "moe_attn"):
        return [(fa, "flash_attention", cfg.n_layers)]
    out = [(la, "linear_attn", cfg.n_layers)]
    if cfg.n_shared_sites:
        out.append((fa, "flash_attention", cfg.n_shared_sites))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "mixtral-8x22b"])
def test_engine_on_the_card(arch):
    """The smoke config on the card: the forward's logits are the CPU's
    (f32, TF32 off, rtol/atol 1e-4), every prefill goes through the arch's
    kernels (flash attention; linear attention for RWKV6; both for zamba2,
    Mamba2 layers and shared sites), and each served token is its
    position's greedy token in a teacher-forced forward on the card
    (within 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke(arch)
    cpu = T.Transformer(cfg, device="cpu")
    card = T.Transformer(cfg, device="meta")
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    toks = torch.from_numpy(np.stack(prompts(cfg.vocab, (20, 20))))
    want, _ = T.forward(cpu, {"tokens": toks})
    got, _ = T.forward(card, {"tokens": toks.cuda()})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    eng = engine.Engine(card, slots=2, max_len=32)
    for rid, pr in enumerate(prompts(cfg.vocab, (12,) * 3, seed=5)):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=6))
    kernels = card_kernels(cfg)
    for counters, _, _ in kernels:
        counters.LAUNCHES.clear()
    fa.VARIANTS.clear()
    done = eng.run()
    for counters, key, per_prefill in kernels:
        assert counters.LAUNCHES[key] == 3 * per_prefill
        if counters is fa:                   # f32 smoke heads: FMA kernel
            assert fa.VARIANTS == {"fma": 3 * per_prefill}
    for r in done:
        seq = np.concatenate([r.prompt, r.out[:-1]]).astype(np.int32)
        logits, _ = T.forward(card, {"tokens": torch.from_numpy(seq)[None]
                                     .cuda()})
        pos = logits[0, len(r.prompt) - 1:]
        picked = pos.gather(1, torch.tensor(r.out, device="cuda")[:, None])
        assert torch.all(pos.amax(1) - picked[:, 0] <= 1e-4), r.rid


#: Limits on bf16 logits (f32 after the unembedding), as in
#: ``chip_smoke.py``: the kernel route's last-position prefill logits
#: against the plain route's (``ROUTE_ATOL["bfloat16"]``), and a served
#: token's logit below its position's maximum in a teacher-forced forward
#: (``SELFCHECK_TOL``).
BF16_ROUTE_ATOL = 0.1
BF16_SELFCHECK_TOL = 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b"])
def test_bf16_engine_on_the_card_goes_through_wgmma(arch):
    """The smoke config in bf16 with 64-wide heads: every prefill of the
    served run goes through the ``wgmma`` flash kernel, none through the
    FMA kernel; each prompt's last-position prefill logits are the plain
    route's (``attn_impl="naive"``, same weights) within
    ``BF16_ROUTE_ATOL``, and each served token is within
    ``BF16_SELFCHECK_TOL`` of its position's maximum logit in a
    teacher-forced forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(configs.get_smoke(arch), head_dim=64,
                              param_dtype="bfloat16")
    model = T.Transformer(cfg, device="cuda")
    eng = engine.Engine(model, slots=2, max_len=80)
    # equal lengths within each batch of two slots: the engine decodes
    # unequal prompts at shifted positions (ROADMAP §3), which the
    # teacher-forced check would flag
    requests = prompts(cfg.vocab, (64, 64, 70), seed=7)
    for rid, pr in enumerate(requests):
        eng.submit(engine.Request(rid=rid, prompt=pr, max_new=5))
    fa.LAUNCHES.clear()
    fa.VARIANTS.clear()
    done = eng.run()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 3 * cfg.n_layers
    assert fa.VARIANTS == {"wgmma": 3 * cfg.n_layers}
    assert all(len(r.out) == 5 and all(0 <= t < cfg.vocab for t in r.out)
               for r in done)
    plain = T.Transformer(dataclasses.replace(cfg, attn_impl="naive"),
                          device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    for pr in requests:
        toks = torch.from_numpy(pr.astype(np.int32))[None].cuda()
        got, _ = T.forward(model, {"tokens": toks})
        want, _ = T.forward(plain, {"tokens": toks})
        torch.testing.assert_close(got[0, -1].float(), want[0, -1].float(),
                                   rtol=0, atol=BF16_ROUTE_ATOL)
    for r in done:
        seq = np.concatenate([r.prompt, r.out[:-1]]).astype(np.int32)
        logits, _ = T.forward(model, {"tokens": torch.from_numpy(seq)[None]
                                      .cuda()})
        pos = logits[0, len(r.prompt) - 1:].float()
        picked = pos.gather(1, torch.tensor(r.out, device="cuda")[:, None])
        assert torch.all(pos.amax(1) - picked[:, 0] <= BF16_SELFCHECK_TOL), \
            r.rid


# ---------------------------------------------------------------------------
# decode with the cache length on the device, and the captured step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b", "zamba2-1.2b",
                                  "mixtral-8x22b"])
@pytest.mark.parametrize("lengths", sorted(PROMPT_LENGTHS))
def test_decode_with_a_device_tensor_length_serves_the_jax_tokens(
        arch, lengths, jx):
    """The decode loop written out with the cache length as a 0-d tensor
    that the loop advances in place (what the captured step does) serves
    the JAX engine's tokens, up to a near-tie (``TIE_TOL``); and one step
    with the length as a tensor gives bit for bit the logits of the same
    step with the length as an int."""
    jax, jnp, jconfigs, JT, jengine = jx
    jcfg = jconfigs.get_smoke(arch)
    params = JT.init(jcfg, jax.random.PRNGKey(2))
    cfg = configs.get_smoke(arch)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(
        cfg, jax.tree.map(np.asarray, params)))
    prompt_list = prompts(cfg.vocab, PROMPT_LENGTHS[lengths], seed=4)
    max_new, slots = 5, len(prompt_list)
    max_len = max(PROMPT_LENGTHS[lengths]) + max_new + 1
    traced = jax_engine_logits(jx, jcfg, params, prompt_list, max_new, slots,
                               max_len)

    prefill = engine.make_prefill_step(model, max_len)
    caches, toks = [], []
    for pr in prompt_list:
        tok, cache = prefill({"tokens": torch.from_numpy(pr)[None]})
        caches.append(cache)
        toks.append(tok)
    cache = [{name: torch.cat([c[entry][name] for c in caches])
              for name in caches[0][entry]}
             for entry in range(len(caches[0]))]
    toks = torch.cat(toks)
    length = torch.tensor(max(PROMPT_LENGTHS[lengths]) + 1)
    as_int = [{k: v.clone() for k, v in c.items()} for c in cache]
    want, _ = T.decode_step(model, toks, as_int, int(length))
    served = [[int(t)] for t in toks[:, 0]]
    for step in range(max_new - 1):
        logits, cache = T.decode_step(model, toks, cache, length)
        if step == 0:
            assert logits.numpy().tobytes() == want.numpy().tobytes()
            assert all(torch.equal(a[k], b[k]) for a, b in zip(cache, as_int)
                       for k in a)
        toks = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        length.add_(1)
        for i, t in enumerate(toks[:, 0].tolist()):
            served[i].append(t)
    for rid, got in enumerate(served):
        for i, (tok, (jtok, jlogits)) in enumerate(zip(got, traced[rid])):
            if tok == jtok:
                continue
            gap = top_two_gap(jlogits)
            assert gap < TIE_TOL, (arch, rid, i, tok, jtok, gap)
            warnings.warn(f"{arch} request {rid} token {i}: port {tok}, JAX "
                          f"{jtok} at a near-tie (top-two gap {gap})")
            break


def test_engine_keeps_decode_runners_per_batch_size():
    """Five requests on two slots decode in batches of 2, 2 and 1: two
    runners (the last batch gets its own, never padded), one memory hit,
    the capture time apart from ``decode_s``, and the tokens of the eager
    step (``graphs=False``, no runner cached) exactly."""
    cfg = configs.get_smoke("qwen3-0.6b")
    model = T.Transformer(cfg, device="cpu")
    out = {}
    for graphs in (True, False):
        eng = engine.Engine(model, slots=2, max_len=24, graphs=graphs)
        for rid, pr in enumerate(prompts(cfg.vocab, (9, 14, 6, 11, 3))):
            eng.submit(engine.Request(rid=rid, prompt=pr, max_new=5))
        out[graphs] = {r.rid: r.out for r in eng.run()}
        cc = eng.compile_cache.as_dict()
        if graphs:
            assert cc["compiles"] == 2 and cc["mem_hits"] == 1
        else:
            assert cc["compiles"] == 0 and cc["mem_hits"] == 0
        assert cc["captures"] == 0                   # CPU: the eager body
        assert eng.stats.capture_s >= 0.0 and eng.stats.decode_steps == 12
    assert out[True] == out[False]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b", "zamba2-1.2b",
                                  "mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
def test_graph_decode_serves_the_eager_tokens_on_the_card(arch):
    """On the card the captured decode step serves the eager step's tokens
    exactly, and its last-step logits within 1e-4 (f32: cuBLAS may pick
    another algorithm under capture, which reorders sums); one capture a
    batch size, replays one a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke(arch)
    model = T.Transformer(cfg, device="cuda")
    got = {}
    for graphs in (True, False):
        eng = engine.Engine(model, slots=2, max_len=40, graphs=graphs)
        for rid, pr in enumerate(prompts(cfg.vocab, (12, 12, 20), seed=5)):
            eng.submit(engine.Request(rid=rid, prompt=pr, max_new=6))
        tokens = {r.rid: r.out for r in eng.run()}
        last = eng.last_logits.float().cpu()
        got[graphs] = (tokens, last, eng.compile_cache.as_dict())
    assert got[True][0] == got[False][0]
    assert (got[True][1] - got[False][1]).abs().max() <= 1e-4
    cc = got[True][2]
    assert cc["captures"] == 2 and cc["replays"] == 2 * 5  # 2 rounds
