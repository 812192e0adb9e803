"""AdamW with warmup-cosine schedule, global-norm clipping, and a
configurable moment dtype: the JAX package's ``repro/train/optimizer.py``
on dicts of tensors keyed by parameter name.

The update is computed in f32 and the moments round-trip through
``moment_dtype``, as in JAX; every factor it applies (``lr``, ``bc1``,
``bc2``, the clip ``scale``) is an f32 tensor, never a Python double, so
the arithmetic is JAX's f32 arithmetic.  Parameters and moments are
updated in place.

The weight-decay mask follows the JAX package's rank rule
(``optimizer.py:86``, ``p.ndim >= 2``) on the JAX package's leaves.  JAX
stacks each layer's parameters over the periods, so there a per-layer
norm scale ``(L, d)`` is a matrix and is decayed, and so are Mamba2's
``a_log``, ``d_skip`` and ``dt_bias``; the port keeps one tensor per
layer.  :func:`decays` therefore counts one more axis for a leaf that JAX
stacks (``layers.*``, ``cross.*``, ``encoder.layers.*``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch

Params = Mapping[str, torch.Tensor]

#: The name prefixes of the leaves the JAX package stacks over a layer
#: axis (``blocks{i}``, ``cross``, ``encoder.blocks``).
STACKED = ("layers.", "cross.", "encoder.layers.")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32   # bf16 for 100B+ models


class OptState(NamedTuple):
    step: torch.Tensor       # ()  int32
    mu: Dict[str, torch.Tensor]   # first moment, by parameter name
    nu: Dict[str, torch.Tensor]   # second moment, by parameter name


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``·lr (f32)."""
    step_f = torch.as_tensor(step).float()
    warm = step_f / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step_f - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step_f < cfg.warmup_steps, warm, cos)


def init(cfg: OptConfig, params: Params) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    device = next(iter(params.values())).device if params else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu={k: zeros(p) for k, p in params.items()},
                    nu={k: zeros(p) for k, p in params.items()})


def global_norm(tree: Params) -> torch.Tensor:
    """The f32 L2 norm over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight-decay mask: the rank of the leaf as the JAX package holds
    it is at least 2 (matrices, and every leaf JAX stacks over layers)."""
    return p.dim() + name.startswith(STACKED) >= 2


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, which XLA's and CUDA's
    ``sqrtf`` are; PyTorch's vectorized CPU ``sqrt`` is not (an ulp off on
    some inputs), so on the CPU it goes through f64, which rounds to the
    same f32 as a correctly rounded f32 root."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


@torch.no_grad()
def update(cfg: OptConfig, grads: Params, state: OptState, params: Params
           ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and the moments.  Returns
    ``(params, new_state, {"grad_norm" (before clipping), "lr"})``."""
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    for name, p in params.items():
        g, mu, nu = grads[name], state.mu[name], state.nu[name]
        gf = g.float() * scale
        mu_f = b1 * mu.float() + (1 - b1) * gf
        nu_f = b2 * nu.float() + (1 - b2) * gf * gf
        upd = (mu_f / bc1) / (_sqrt(nu_f / bc2) + cfg.eps)
        if decays(name, p) and cfg.weight_decay > 0:
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        mu.copy_(mu_f)
        nu.copy_(nu_f)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                         "lr": lr}
