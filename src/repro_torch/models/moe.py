"""Mixture-of-Experts FFN with group-wise capacity dispatch.

The JAX package's ``repro/models/moe.py`` on torch tensors, with its
arithmetic and its types: tokens are reshaped into groups of
``group_size`` (snapped to the largest divisor of the token count, so
every count dispatches exactly); each group routes its tokens by an f32
router and softmax to their ``top_k`` experts, whose gates are
renormalised; each expert takes at most ``capacity = max(ceil(cf ·
group_size · top_k / E), 4)`` tokens of a group, placed in the order of
a cumulative sum over (token, choice), and the overflow is dropped.

Two dispatch forms compute the same function (``dispatch``):

* ``"einsum"`` — the one-hot ``(G, Tg, E, C)`` dispatch and combine
  tensors and three einsums, as Mesh-TF does;
* ``"scatter"`` — ``scatter_add_`` of each kept (token, choice) into a
  flat ``(G, E·C + 1, d)`` buffer whose last row takes the dropped ones,
  and a gather back.

As in JAX the expert products run in f32: the dispatched tokens are f32
(the one-hot promotes them in the einsum form, an explicit cast in the
scatter form), so each product is f32 activations against the experts'
``param_dtype`` weights, which is the weights cast to f32.

Routing ties break as ``jax.lax.top_k`` breaks them, the lower expert
first: the top ``k`` come from a stable descending sort (``torch.topk``
promises no order on ties, and another order moves the cumsum positions
and so which tokens are dropped).  Nothing reads a value on the host —
one-hots are ``eq`` against an ``arange``, slots computed indices — so a
decode step that runs it can be captured in a CUDA graph.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _param

DISPATCHES = ("einsum", "scatter")


def snap_group_size(n_tok: int, group_size: int) -> int:
    """The largest divisor of ``n_tok`` not above ``group_size``."""
    group_size = min(group_size, n_tok)
    while n_tok % group_size:
        group_size -= 1
    return group_size


def capacity_of(group_size: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Each expert's slots a group: ``max(ceil(cf · Tg · k / E), 4)``."""
    return max(int(math.ceil(capacity_factor * group_size * top_k
                             / n_experts)), 4)


def one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: a trailing axis of ``n``, all zeros where
    ``idx`` is outside ``[0, n)``; built by ``eq`` against an
    ``arange``, so it needs no host read."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k_stable(probs: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    descending, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts(p, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their f32 inputs ``(G, E, C, d)``: each
    weight cast to f32 just before its product (one at a time, so that
    at most one f32 copy of a weight is alive)."""
    h = torch.einsum("gecd,edf->gecf", expert_in, p.gate.float())
    u = torch.einsum("gecd,edf->gecf", expert_in, p.up.float())
    act = F.silu(h) * u
    return torch.einsum("gecf,efd->gecd", act, p.down.float())


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 512,
              dispatch: str = "einsum"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, T, d)`` → ``(out (B, T, d) in x's type, aux f32 scalar)``.

    ``p`` is a :class:`MoE`: ``router.w (d, E)`` f32 and the stacked
    experts ``gate``, ``up`` ``(E, d, ff)`` and ``down`` ``(E, ff, d)``."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch {dispatch!r}")
    b, t, d = x.shape
    e = p.router.w.shape[1]
    n_tok = b * t
    group_size = snap_group_size(n_tok, group_size)
    g = n_tok // group_size
    xg = x.reshape(g, group_size, d)

    logits = xg.float() @ p.router.w                           # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)

    # --- top-k selection + renormalised gates -----------------------------
    gate_vals, gate_idx = top_k_stable(probs, top_k)           # (G, Tg, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    capacity = capacity_of(group_size, top_k, e, capacity_factor)

    # position of each (token, choice) in its expert's buffer
    onehot = one_hot(gate_idx, e, torch.int32)                 # (G,Tg,k,E)
    flat = onehot.reshape(g, group_size * top_k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat           # (G,Tg*k,E)
    pos = (pos_in_expert.reshape(g, group_size, top_k, e)
           * onehot).sum(dim=-1)                               # (G, Tg, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep

    if dispatch == "scatter":
        # flat (E·C) buffer index per (token, choice); dropped slots → a
        # trash row appended at the end of the buffer
        slot = torch.where(keep, gate_idx * capacity + pos, e * capacity)
        buf = torch.zeros((g, e * capacity + 1, d), dtype=torch.float32,
                          device=x.device)
        src = xg.float()[:, :, None, :].expand(
            g, group_size, top_k, d).reshape(g, group_size * top_k, d)
        buf.scatter_add_(1, slot.reshape(g, -1, 1).expand(-1, -1, d), src)
        expert_in = buf[:, :-1].reshape(g, e, capacity, d)
        expert_out = _experts(p, expert_in)
        flat_out = expert_out.reshape(g, e * capacity, d)
        safe_slot = torch.clamp(gate_idx * capacity + pos,
                                max=e * capacity - 1).reshape(g, -1)
        picked = torch.gather(
            flat_out, 1, safe_slot[..., None].expand(-1, -1, d)
        ).reshape(g, group_size, top_k, d)                      # (G,Tg,k,d)
        out = torch.sum(picked * gate_vals[..., None], dim=2)
    else:
        # dispatch/combine one-hots: (G, Tg, E, C)
        pos_hot = one_hot(pos, capacity)
        disp = torch.einsum("gtke,gtkc->gtec",
                            onehot.float() * keep[..., None], pos_hot)
        comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot.float(), pos_hot,
                            gate_vals)
        expert_in = torch.einsum("gtec,gtd->gecd", disp, xg.float())
        expert_out = _experts(p, expert_in)
        out = torch.einsum("gtec,gecd->gtd", comb, expert_out)

    # --- load-balancing auxiliary loss (Switch-style) ----------------------
    density = torch.mean(one_hot(gate_idx[..., 0], e).sum(dim=1)
                         / group_size, dim=0)                   # (E,)
    mean_probs = torch.mean(probs, dim=(0, 1))                  # (E,)
    aux = e * torch.sum(density * mean_probs)

    return out.reshape(b, t, d).to(x.dtype), aux


class MoE(nn.Module):
    """The routed experts (the JAX package's ``moe_init``), applied by
    :func:`moe_apply`: ``router`` a :class:`Dense` in f32 whatever the
    model's type, and ``gate``, ``up`` ``(E, d, ff)`` and ``down`` ``(E,
    ff, d)`` in ``dtype``, truncated-normal in [-2, 2] times ``1/sqrt(d)``
    (``down``: ``1/sqrt(ff)``), the JAX parameter names and layout."""

    def __init__(self, d: int, ff: int, n_experts: int, *, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.router = Dense(d, n_experts, dtype=torch.float32, device=device,
                            generator=generator)

        def fill(scale):
            def init(t):
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                t.mul_(scale)
            return init

        self.gate = _param((n_experts, d, ff), dtype, device,
                           fill(1.0 / math.sqrt(d)))
        self.up = _param((n_experts, d, ff), dtype, device,
                         fill(1.0 / math.sqrt(d)))
        self.down = _param((n_experts, ff, d), dtype, device,
                           fill(1.0 / math.sqrt(ff)))
