"""The port's pipeline module (``repro_torch.parallel.pipeline``) against
the JAX package's (``repro.parallel.pipeline``), on the CPU:

* ``evaluate_pp`` equals JAX's bit for bit (step, ideal, bubble) on gpipe
  and 1f1b over a grid of stages, microbatches and p2p costs, through the
  port's own simulator;
* ``stage_bounds``/``stage_slices`` split like JAX's ``stage_slices``
  (Python's half-even ``round``: 5 periods over 2 stages are 2 + 3), and
  on the qwen3-4b smoke model the port's stages hold JAX's stacked
  slices' weights (through ``import_lm_params``);
* ``staged_prefill`` (microbatches through stage 0, then stage 1) equals
  the unstaged ``prefill`` in f32 (rtol 1e-5 / atol 1e-6), and refuses a
  stack with a shared block or an encoder.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.parallel import pipeline as jpp

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.models import transformer as T
from repro_torch.parallel import pipeline as pp

GRID = [(s, m) for s in (1, 2, 3, 4, 6) for m in (1, 2, 4, 5, 8, 16)]


@pytest.mark.parametrize("schedule", ("gpipe", "1f1b"))
@pytest.mark.parametrize("p2p", (0.0, 0.3))
def test_evaluate_pp_equals_jax(schedule, p2p):
    for s, m in GRID:
        for fwd, bwd in ((1.0, 2.0), (0.7, 1.3)):
            a = pp.evaluate_pp(pp.PPConfig(s, m, fwd, bwd, p2p, schedule))
            b = jpp.evaluate_pp(jpp.PPConfig(s, m, fwd, bwd, p2p, schedule))
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (s, m)


def test_stage_bounds_equal_jax_half_even():
    for n_periods in range(1, 13):
        stacked = jnp.arange(n_periods)[:, None]
        for n_stages in range(1, 7):
            sizes = [int(x.shape[0]) for x in
                     jpp.stage_slices(stacked, n_stages)]
            b = pp.stage_bounds(n_periods, n_stages)
            assert [b[i + 1] - b[i] for i in range(n_stages)] == sizes
            assert [len(x) for x in pp.stage_slices(
                list(range(n_periods)), n_stages)] == sizes
    assert pp.stage_bounds(5, 2) == [0, 2, 5]        # half to even
    assert pp.stage_bounds(7, 2) == [0, 4, 7]
    with pytest.raises(ValueError, match="whole periods"):
        pp.stage_slices(list(range(5)), 2, period=2)


def test_stages_hold_jax_slices():
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-4b"),
                               param_dtype="float32")
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"),
                              param_dtype="float32")
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(import_lm_params(cfg, params), strict=True)
    jstages = jpp.stage_slices(params["blocks0"], 2)
    stages = pp.stage_slices(model.layers, 2, period=len(cfg.pattern))
    assert [len(s) for s in stages] == \
        [jax.tree.leaves(s)[0].shape[0] for s in jstages]
    for js, st in zip(jstages, stages):
        for i, layer in enumerate(st):
            want = import_lm_params(cfg, {"blocks0": jax.tree.map(
                lambda a: a[i:i + 1], js)})
            for name, t in layer.state_dict().items():
                torch.testing.assert_close(t, want[f"layers.0.{name}"],
                                           rtol=0, atol=0)


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "gemma2-2b"))
def test_staged_prefill_equals_prefill(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype="float32",
                              attn_impl="chunked")
    model = T.Transformer(cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 20), dtype=np.int32))}
    want, wcache = T.prefill(model, batch, 24)
    got, cache = pp.staged_prefill(model, batch, 24, n_stages=2, n_micro=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert len(cache) == len(wcache)
    for c, w in zip(cache, wcache):
        assert c.keys() == w.keys()
        for k in c:
            torch.testing.assert_close(c[k], w[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ("zamba2-1.2b", "whisper-tiny"))
def test_staged_prefill_refuses_shared_and_encoder(arch):
    model = T.Transformer(configs.get_smoke(arch), device="meta")
    with pytest.raises(ValueError, match="plain periods"):
        pp.staged_prefill(model, {}, 8, 2, 1)
