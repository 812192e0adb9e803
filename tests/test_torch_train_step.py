"""The port's loss and gradients (``repro_torch.models.transformer.
lm_loss``, ``repro_torch.train.step.value_and_grad``) against the JAX
package's, on the CPU, from the JAX package's smoke weights
(``import_lm_params``) and numpy-seeded batches, in f32:

* loss, aux and every gradient against ``jax.value_and_grad`` of JAX's
  ``lm_loss`` for the smoke configs of qwen3-0.6b, mixtral-8x22b,
  rwkv6-1.6b, zamba2-1.2b, whisper-tiny and pixtral-12b, JAX's gradient
  tree mapped through ``import_lm_params``, at rtol 1e-4 / atol 1e-6
  (measured: within 3e-6; labels below 0 are masked on both sides);
* ``make_train_step`` refuses the kernel route, and the kernel wrappers
  raise ``NotImplementedError`` on operands that require grad (here on
  the CPU, where they would otherwise run their plain versions);
* a ``gpu``-marked test: one step on the card against the same step on
  the CPU.

The full step, accumulation, remat and compression are in
``test_torch_train_update.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.carry import import_lm_params
from repro_torch.kernels import lockstep_step as ls
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.train import step as S

from torch_train_common import batch_for, close, pair, port_step, torch_batch

ARCHS = ("qwen3-0.6b", "mixtral-8x22b", "rwkv6-1.6b", "zamba2-1.2b",
         "whisper-tiny", "pixtral-12b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    jcfg, params, cfg, model = pair(arch)
    batch = batch_for(cfg, 1)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(params)
    total, m, grads = S.value_and_grad(S.make_loss_fn(cfg, 0.01), model,
                                       torch_batch(batch))
    close(total, jtotal, what="total")
    close(m["loss"], jm["loss"], what="loss")
    close(m["aux"], jm["aux"], what="aux")
    want = import_lm_params(cfg, jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want) == set(dict(model.named_parameters()))
    for name, g in grads.items():
        close(g, want[name], what=name)
    if arch == "mixtral-8x22b":
        assert float(m["aux"]) > 0


def test_lm_loss_masks_negative_labels():
    _, _, cfg, model = pair("qwen3-0.6b")
    batch = torch_batch(batch_for(cfg, 2, masked=False))
    with torch.no_grad():
        full, _ = T.lm_loss(model, batch)
        labels = batch["labels"].clone()
        labels[:, ::2] = -1
        half, _ = T.lm_loss(model, {**batch, "labels": labels})
        logits, _ = T.forward(model, batch)
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    close(full, nll.mean(), rtol=1e-6)
    close(half, nll[:, 1::2].mean(), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_make_train_step_refuses_the_kernel_route(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), attn_impl="kernel")
    with pytest.raises(ValueError, match="chunked"):
        S.make_train_step(cfg, S.TrainConfig())


def test_served_model_stays_frozen_and_kernel_route_raises_under_grad():
    """A model is built frozen; once a train step's ``trainable`` turns
    its parameters on, a forward on the kernel route raises rather than
    running the kernels' plain versions."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              param_dtype="float32")
    model = T.Transformer(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    batch = torch_batch(batch_for(cfg, 8))
    T.forward(model, batch)                  # serving: fine
    S.trainable(model)
    with pytest.raises(NotImplementedError, match="no backward"):
        T.forward(model, batch)
    with torch.no_grad():
        T.forward(model, batch)


def wrapper_calls():
    """Each kernel wrapper with CPU operands of its contract."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    upper = torch.triu(rnd(16, 16)) + 4 * torch.eye(16)
    P, S_, B = 2, 4, 8
    f64 = dict(dtype=torch.float64)
    return {
        "attention": (ops.attention, (rnd(4, 8, 16), rnd(2, 8, 16),
                                      rnd(2, 8, 16))),
        "linear_attn": (ops.linear_attn, (rnd(4, 8, 16), rnd(4, 8, 16),
                                          rnd(4, 8, 16),
                                          torch.rand(4, 8, 16, generator=g),
                                          rnd(2, 16))),
        "linear_attn_state": (ops.linear_attn_state,
                              (rnd(4, 8, 16), rnd(4, 8, 16), rnd(4, 8, 16),
                               torch.rand(4, 8, 16, generator=g),
                               rnd(2, 16))),
        "matmul": (ops.matmul, (rnd(16, 8), rnd(8, 16))),
        "syrk": (ops.syrk, (rnd(16, 16), rnd(16, 16))),
        "trsm": (ops.trsm, (upper, rnd(16, 16))),
        "gemm_update": (ops.gemm_update, (rnd(16, 16), rnd(16, 16),
                                          rnd(16, 16))),
        "step_commit": (ls.step_commit, (
            torch.zeros(P, S_, B, **f64), torch.zeros(P, B, **f64),
            torch.zeros(P, B, dtype=torch.bool),
            torch.zeros(B, dtype=torch.int64), torch.ones(B, **f64),
            torch.ones(B, **f64), torch.ones(B, dtype=torch.bool))),
    }


@pytest.mark.parametrize("name", sorted(wrapper_calls()))
def test_kernel_wrappers_refuse_operands_that_require_grad(name):
    fn, args = wrapper_calls()[name]
    # float operands only can require grad; the first float one does here
    i = next(i for i, a in enumerate(args) if a.is_floating_point())
    live = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(*live)
    with torch.no_grad():                    # not recorded: runs
        fn(*live)
    fn(*args)


# ------------------------------------------------------------ on the card ---

@pytest.mark.gpu
def test_card_step_matches_cpu_step():
    """One step of qwen3-0.6b's smoke config (the port's seeded weights,
    f32) on the card against the same step on the CPU, from the same
    weights and batch, at JAX's bounds for two equivalent steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              param_dtype="float32", attn_impl="chunked")
    cpu_model = T.Transformer(cfg, device="cpu")
    card_model = T.Transformer(cfg, device="meta").to_empty(device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    batch = batch_for(cfg, 9, b=4, t=32)
    kw = {"opt": dict(lr=1e-2)}          # JAX's test's: lr 1e-4 at step 1
    cpu_model, _, cm = port_step(cfg, cpu_model, kw, batch)
    card_model, _, gm = port_step(cfg, card_model, kw, batch)
    for k in ("loss", "grad_norm"):
        close(gm[k].cpu(), cm[k], rtol=1e-4, atol=0, what=k)
    for (name, a), (_, b) in zip(card_model.named_parameters(),
                                 cpu_model.named_parameters()):
        close(a.detach().cpu(), b.detach(), rtol=2e-3, atol=2e-5, what=name)
