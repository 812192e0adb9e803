"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's (``repro.train.optimizer``), on the CPU.

* ``schedule`` at every step 0..120 of two warmup-cosine configs, at rtol
  1e-6 (both compute in f32; ``cos`` may differ by an ulp);
* ``update`` on the smoke parameter trees of four archs, JAX's stacked
  leaves against the port's per-layer ones, with seeded gradients over
  three steps: parameters and moments at rtol 1e-6 / atol 1e-7 in f32.
  The weight-decay mask is JAX's rank rule on the stacked leaves: every
  per-layer norm scale and Mamba2's ``a_log``/``d_skip``/``dt_bias`` are
  decayed, ``final_norm`` and zamba2's shared block's norms are not;
* clipping reports the norm before clipping;
* bf16 moments (and bf16 parameters) bit for bit equal to JAX's (the
  f32 square root correctly rounded on both sides);
* the quadratic converges.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the JAX package is the reference; a card without it skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.train import optimizer as jopt

from repro_torch import configs
from repro_torch.carry import import_lm_params, import_opt_state
from repro_torch.train import optimizer as opt

ARCHS = ("qwen3-0.6b", "zamba2-1.2b", "whisper-tiny", "mixtral-8x22b")


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def jax_tree(arch, dtype="float32"):
    """The JAX smoke params (numpy leaves) and the port's config."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), param_dtype=dtype)
    params = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(0)))
    return params, dataclasses.replace(configs.get_smoke(arch),
                                       param_dtype=dtype)


def seeded_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32)
        .astype(p.dtype), params)


@pytest.mark.parametrize("warmup,total", [(10, 110), (0, 100), (100, 50)])
def test_schedule_matches_jax(warmup, total):
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    jcfg = jopt.OptConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    got = [float(opt.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(121)]
    want = [float(jopt.schedule(jcfg, jnp.int32(s))) for s in range(121)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_schedule_warmup_then_cosine():
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                        min_lr_ratio=0.1)
    lr = [float(opt.schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 110)]
    assert lr[0] == 0.0 and abs(lr[1] - 5e-4) < 1e-9
    assert abs(lr[2] - 1e-3) < 1e-6 and abs(lr[3] - 1e-4) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_is_jax_rank_rule(arch):
    params, cfg = jax_tree(arch)
    mask = import_lm_params(cfg, jax.tree.map(
        lambda p: np.full(p.shape, p.ndim >= 2), params))
    got = {name: opt.decays(name, p) for name, p in
           import_lm_params(cfg, params).items()}
    want = {name: bool(m.all()) for name, m in mask.items()}
    assert got == want
    if arch == "zamba2-1.2b":
        assert got["layers.0.a_log"] and got["layers.0.ln.scale"]
        assert not got["shared.ln1.scale"] and not got["final_norm.scale"]


@pytest.mark.parametrize("arch", ARCHS)
def test_update_matches_jax(arch):
    params, cfg = jax_tree(arch)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=50.0)
    jcfg, pcfg = jopt.OptConfig(**ocfg), opt.OptConfig(**ocfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jcfg, jparams)
    port = import_lm_params(cfg, params)
    state = opt.init(pcfg, port)
    for step in range(3):
        g = seeded_grads(params, step)
        jparams, jstate, jm = jopt.update(
            jcfg, jax.tree.map(jnp.asarray, g), jstate, jparams)
        _, state, m = opt.update(pcfg, import_lm_params(cfg, g), state, port)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert float(m["lr"]) == float(jm["lr"])
    want = import_lm_params(cfg, jax.tree.map(np.asarray, jparams))
    want_state = import_opt_state(cfg, jax.tree.map(np.asarray, jstate))
    assert int(state.step) == int(want_state.step) == 3
    for name in port:
        for got, ref in ((port[name], want[name]),
                         (state.mu[name], want_state.mu[name]),
                         (state.nu[name], want_state.nu[name])):
            np.testing.assert_allclose(f32(got), f32(ref), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_clipping_reports_norm_before_clipping():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=0, clip_norm=1.0,
                        weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    _, _, metrics = opt.update(cfg, {"w": torch.full((4,), 1e6)},
                               opt.init(cfg, params), params)
    assert float(metrics["grad_norm"]) > 1e6
    # the step itself is clipped: Adam's first step moves by lr alone
    np.testing.assert_allclose(params["w"].numpy(), -np.ones(4), rtol=1e-6)


def test_bf16_moments_bit_equal_to_jax():
    """Clipping is off here (a norm far below ``clip_norm``): the global
    norm sums the port's per-layer leaves in another order than JAX's
    stacked ones, an f32 ulp of the clip scale that can move a bf16
    rounding; with clipping on, the f32 test above holds it at 1e-6."""
    params, cfg = jax_tree("qwen3-0.6b", "bfloat16")
    kw = dict(moment_dtype=None, lr=0.1, warmup_steps=1, clip_norm=1e9)
    jcfg = jopt.OptConfig(**{**kw, "moment_dtype": jnp.bfloat16})
    pcfg = opt.OptConfig(**{**kw, "moment_dtype": torch.bfloat16})
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jcfg, jparams)
    port = import_lm_params(cfg, params)
    state = opt.init(pcfg, port)
    for step in range(3):
        g = seeded_grads(params, 10 + step)
        jparams, jstate, _ = jopt.update(
            jcfg, jax.tree.map(jnp.asarray, g), jstate, jparams)
        _, state, _ = opt.update(pcfg, import_lm_params(cfg, g), state, port)
    want = import_lm_params(cfg, jax.tree.map(np.asarray, jparams))
    want_state = import_opt_state(cfg, jax.tree.map(np.asarray, jstate))
    for name in port:
        assert state.mu[name].dtype == port[name].dtype == torch.bfloat16
        for got, ref in ((port[name], want[name]),
                         (state.mu[name], want_state.mu[name]),
                         (state.nu[name], want_state.nu[name])):
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          ref.view(torch.int16).numpy(),
                                          err_msg=name)


def test_adamw_converges_on_quadratic():
    cfg = opt.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                        weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([1.5, -2.0, 0.5])
    w = torch.zeros(3, requires_grad=True)
    params = {"w": w}
    state = opt.init(cfg, params)
    for _ in range(150):
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        _, state, _ = opt.update(cfg, {"w": g}, state, params)
    np.testing.assert_allclose(w.detach().numpy(), target.numpy(), atol=0.05)
