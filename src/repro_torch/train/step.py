"""Train step factory: loss → grads → AdamW update, with microbatched
gradient accumulation, remat, and optional gradient compression — the
JAX package's ``repro/train/step.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, where ``params`` is the
:class:`~repro_torch.models.transformer.Transformer` itself: the step
turns ``requires_grad`` on for that model's parameters (a model built
for serving stays frozen until a train step is handed it), takes the
gradients with autograd and updates the model in place.

Training runs the JAX package's training arithmetic, the chunked
attention and linear-attention routes (``attn_impl="chunked"``): the
kernels have no backward, as JAX's Pallas kernels have none, so
:func:`make_train_step` refuses a config that routes to them, and the
kernel wrappers refuse operands that require grad.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import transformer as T
from ..parallel import compression
from . import optimizer as opt_mod

Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_mod.OptConfig = opt_mod.OptConfig()
    accum_steps: int = 1              # microbatched gradient accumulation
    aux_weight: float = 0.01          # MoE load-balance loss weight
    # gradient compression (parallel/compression.py); None = off
    compression: Optional[str] = None  # None | "int8_ef"


def _microbatch(batch: Batch, n: int, i: int) -> Batch:
    """Slice microbatch ``i`` of ``n`` along the leading (batch) axis."""
    def slc(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: slc(v) for k, v in batch.items()}


def make_loss_fn(cfg: T.ModelConfig, aux_weight: float
                 ) -> Callable[[T.Transformer, Batch],
                               Tuple[torch.Tensor, Dict]]:
    def loss_fn(model, batch):
        return T.lm_loss(model, batch, aux_weight=aux_weight)
    return loss_fn


def trainable(model: T.Transformer) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by name, each with ``requires_grad`` on."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def value_and_grad(loss_fn: Callable, model: T.Transformer, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict, Dict[str, torch.Tensor]]:
    """``(total, metrics, grads)``: ``loss_fn``'s value and metrics,
    detached, and its gradient with respect to every parameter, by name,
    in the parameter's type (zeros for a parameter the loss does not
    reach, as JAX gives).  A parameter used twice (a tied embedding,
    zamba2's shared block) gets one gradient, summed over its uses."""
    params = trainable(model)
    total, metrics = loss_fn(model, batch)
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(params.items(), grads)})


def check_routes(cfg: T.ModelConfig) -> None:
    """``ValueError`` when a layer of ``cfg`` would route to a kernel:
    the kernels have no backward."""
    if cfg.attn_impl == "kernel":
        raise ValueError(
            f"{cfg.name}: attn_impl='kernel' routes attention and linear "
            f"attention through kernels that have no backward; train with "
            f"attn_impl='chunked', the JAX package's training arithmetic")


def _on(batch: Batch, device: torch.device) -> Batch:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: T.ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[T.Transformer, opt_mod.OptState, Batch],
                                  Tuple[T.Transformer, opt_mod.OptState,
                                        Dict]]:
    check_routes(cfg)
    loss_fn = make_loss_fn(cfg, tcfg.aux_weight)

    def compute_grads(model, batch):
        if tcfg.accum_steps <= 1:
            return value_and_grad(loss_fn, model, batch)
        n = tcfg.accum_steps
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                 for name, p in model.named_parameters()}
        for i in range(n):
            loss, _, mb_grads = value_and_grad(loss_fn, model,
                                               _microbatch(batch, n, i))
            for name, g in mb_grads.items():
                grads[name].add_(g)
            loss_sum = loss_sum + loss
        inv = 1.0 / n
        return loss_sum * inv, {}, {name: g * inv
                                    for name, g in grads.items()}

    def train_step(model, opt_state, batch):
        loss, metrics, grads = compute_grads(model, _on(batch, model.device))
        if tcfg.compression == "int8_ef":
            grads = compression.fake_quant_int8(grads)
        _, opt_state, opt_metrics = opt_mod.update(
            tcfg.opt, grads, opt_state, dict(model.named_parameters()))
        out = {"loss": loss, **opt_metrics}
        out.update({k: v for k, v in metrics.items() if k != "loss"})
        return model, opt_state, out

    return train_step


def init_train_state(cfg: T.ModelConfig, tcfg: TrainConfig, seed: int = 0,
                     *, device=None
                     ) -> Tuple[T.Transformer, opt_mod.OptState]:
    """A model drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the card), trainable, and its optimizer state."""
    device = T.resolve_device(device)
    model = T.Transformer(cfg, device=device, generator=torch.Generator(
        device).manual_seed(seed))
    return model, opt_mod.init(tcfg.opt, trainable(model))
