"""The port's train step (``repro_torch.train.step``) against the JAX
package's, on the CPU, from the JAX package's smoke weights and
numpy-seeded batches, in f32:

* one full step (loss, grad norm, lr, updated parameters and moments)
  against JAX's jitted step, and ``accum_steps=2`` against JAX's: the
  metrics at rtol 1e-5, the first moments (a tenth of the gradients) at
  rtol 1e-4 / atol 1e-7, the parameters at JAX's own bounds for two
  equivalent steps (``tests/test_train_step.py``: rtol 2e-3 / atol 2e-5)
  wherever the gradient is at least 1e-5.  Adam's first step moves a
  parameter by ``lr·g/(|g| + eps)``, which turns f32 noise in a gradient
  near ``eps`` into a move of up to ``lr``; there the two steps are held
  within ``2·lr`` (measured: 1.4e-4 at lr 5e-3 on one of zamba2's
  elements);
* accumulation over two microbatches equals one batch at JAX's bounds;
* ``remat`` ``none``, ``full`` and ``dots`` give the same loss and
  gradients, and recompute what JAX's policies recompute;
* the compression hook trains.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the JAX package is the reference; a card without it skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jopt
from repro.train import step as jstep

from repro_torch import configs
from repro_torch.carry import import_lm_params, import_opt_state
from repro_torch.models import transformer as T
from repro_torch.train import step as S

from torch_train_common import batch_for, close, pair, port_step, torch_batch


def jax_step(jcfg, params, tcfg_kw, batch):
    tcfg = jstep.TrainConfig(**tcfg_kw)
    step = jax.jit(jstep.make_train_step(jcfg, tcfg))
    state = jopt.init(tcfg.opt, params)
    p, s, m = step(params, state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), m


@pytest.mark.parametrize("arch,accum", [("qwen3-0.6b", 1),
                                        ("mixtral-8x22b", 1),
                                        ("qwen3-0.6b", 2),
                                        ("zamba2-1.2b", 2)])
def test_train_step_matches_jax(arch, accum):
    jcfg, params, cfg, model = pair(arch)
    batch = batch_for(cfg, 3, b=4, t=16)
    okw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp, js, jm = jax_step(jcfg, params,
                          {"opt": jopt.OptConfig(**okw),
                           "accum_steps": accum}, batch)
    model, state, m = port_step(cfg, model, {"opt": okw,
                                             "accum_steps": accum}, batch)
    assert set(m) == set(jm)            # no "aux" with accumulation
    assert ("aux" in m) == (accum == 1)
    for k in m:
        close(m[k], jm[k], rtol=1e-5, what=k)
    want = import_lm_params(cfg, jp)
    want_state = import_opt_state(cfg, js)
    assert int(state.step) == int(want_state.step) == 1
    for name, p in model.named_parameters():
        close(state.mu[name], want_state.mu[name], atol=1e-7,
              what=f"mu {name}")
        # the clipped gradient, from JAX's first moment (1 - b1)·g
        well = want_state.mu[name].abs() / 0.1 >= 1e-5
        got, ref = p.detach(), want[name]
        close(got[well], ref[well], rtol=2e-3, atol=2e-5, what=name)
        ill = (got - ref)[~well].abs()
        assert ill.numel() == 0 or float(ill.max()) <= 2 * float(jm["lr"])


def test_grad_accumulation_equivalence():
    """accum=2 over a batch equals accum=1 on the same batch at JAX's
    bounds (``tests/test_train_step.py``)."""
    outs = {}
    for accum in (1, 2):
        _, _, cfg, model = pair("qwen3-0.6b")
        model, _, m = port_step(cfg, model, {"opt": dict(lr=1e-2),
                                             "accum_steps": accum},
                                batch_for(cfg, 4, b=4, t=16, masked=False))
        outs[accum] = (model, float(m["loss"]))
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=1e-5)
    for (_, a), (_, b) in zip(outs[1][0].named_parameters(),
                              outs[2][0].named_parameters()):
        close(a.detach(), b.detach(), rtol=2e-3, atol=2e-5)


class OpCount(TorchDispatchMode):
    """Counts the ATen operators run under it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def saved_bytes(fn):
    """Bytes of the tensors autograd keeps for the backward pass of
    ``fn()`` outside any checkpointed region, and its result."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return total[0], out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-tiny",
                                  "zamba2-1.2b"])
def test_remat_modes_agree(arch):
    """Same loss and gradients; ``full`` recomputes the periods' matmuls
    in the backward pass, ``dots`` recomputes their other operations but
    keeps the matmuls' outputs (JAX's ``checkpoint_dots``)."""
    batch = torch_batch(batch_for(configs.get_smoke(arch), 5))
    res, ops_run, kept = {}, {}, {}
    for mode in ("none", "full", "dots"):
        _, _, cfg, model = pair(arch, remat=mode)
        loss_fn = S.make_loss_fn(cfg, 0.01)
        with OpCount() as count:
            kept[mode], res[mode] = saved_bytes(
                lambda: S.value_and_grad(loss_fn, model, batch))
        ops_run[mode] = count.ops
    base = res["none"]
    for mode in ("full", "dots"):
        total, _, grads = res[mode]
        close(total, base[0], rtol=1e-6, atol=0, what=mode)
        for name, g in grads.items():
            close(g, base[2][name], rtol=1e-6, atol=1e-7, what=name)
        assert kept[mode] < kept["none"]
    mm = "aten.mm.default"
    assert ops_run["full"][mm] > ops_run["none"][mm] == ops_run["dots"][mm]
    assert ops_run["dots"]["aten.mul.Tensor"] > \
        ops_run["none"]["aten.mul.Tensor"]


def test_remat_only_where_autograd_records():
    """A frozen model (as served) or a forward under ``no_grad`` runs no
    checkpoint: the logits are the plain forward's, bit for bit."""
    _, _, cfg, model = pair("qwen3-0.6b", remat="full")
    batch = torch_batch(batch_for(cfg, 6))
    nbytes, (logits, _) = saved_bytes(lambda: T.forward(model, batch))
    assert nbytes == 0
    _, _, _, plain = pair("qwen3-0.6b")
    torch.testing.assert_close(logits, T.forward(plain, batch)[0],
                               rtol=0, atol=0)


def test_compression_hook_runs_and_trains():
    _, _, cfg, model = pair("qwen3-0.6b")
    before = model.embed.table.detach().clone()
    model, state, m = port_step(cfg, model, {"opt": dict(lr=1e-3),
                                             "compression": "int8_ef"},
                                batch_for(cfg, 7, b=2, t=16))
    assert np.isfinite(float(m["loss"]))
    assert float((model.embed.table.detach() - before).abs().max()) > 0
    assert int(state.step) == 1
