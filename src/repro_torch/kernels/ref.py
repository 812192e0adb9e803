"""Plain PyTorch versions of the kernels (the correctness contract).

Each function computes the mathematically defined result in f32 with no
tiling, fusion or online accumulation, with the names and contracts of
the JAX package's oracles.  The wrappers in :mod:`.block_matmul`,
:mod:`.cholesky_tiles`, :mod:`.flash_attention` and :mod:`.linear_attn`
run these for CPU tensors; on the card only the tests and
``chip_smoke.py`` call them, to hold the kernels to them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: The masked logit: finite, so a row with no valid key yet gives
#: ``exp(0)`` terms that a later valid key wipes out, never NaN.
NEG_INF = -1e30


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` in f32, cast to ``out_dtype or a.dtype``."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """``q (BH, T, D)``, ``k``/``v`` ``(BKV, S, D)``; GQA by repeating each
    KV head over its ``BH // BKV`` query heads.  Logits in f32, scaled by
    ``scale`` (default ``D**-0.5``), soft-capped, then masked (causal:
    ``k_pos <= q_pos``; window: ``k_pos > q_pos - window``) with
    :data:`NEG_INF`; the output is cast to ``q.dtype``."""
    bh, t, d = q.shape
    bkv, s, _ = k.shape
    group = bh // bkv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("htd,hsd->hts", q.float(), k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask[None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hts,hsd->htd", probs, v.float()).to(q.dtype)


def linear_attention_state(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor,
                           u: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact per-step recurrence, in f32, and its final state:

        o_t = r_t S_{t-1} + ((r_t ⊙ u) · k_t) v_t
        S_t = diag(w_t) S_{t-1} + kᵀ_t v_t,   S_0 = 0

    ``r``/``k``/``w`` ``(BH, T, dk)``, ``v`` ``(BH, T, dv)``, ``u``
    ``(H, dk)`` with ``BH = B x H`` (row ``bh`` takes ``u[bh % H]``).
    Returns ``(out (BH, T, dv) in r's dtype, state (BH, dk, dv) f32)``."""
    bh, t, dk = r.shape
    dv = v.shape[-1]
    u_full = u.float().repeat(bh // u.shape[0], 1)            # (BH, dk)
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(t):
        r_t, k_t, v_t = rf[:, i], kf[:, i], vf[:, i]
        bonus = torch.sum(r_t * u_full * k_t, dim=-1)          # (BH,)
        outs.append(torch.einsum("bk,bkv->bv", r_t, state)
                    + bonus[:, None] * v_t)
        state = wf[:, i, :, None] * state + k_t[:, :, None] * v_t[:, None, :]
    return torch.stack(outs, dim=1).to(r.dtype), state


def linear_attention(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`linear_attention_state`'s output alone."""
    return linear_attention_state(r, k, v, w, u)[0]


def syrk(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c - aᵀ a`` in f32, cast to ``c.dtype``."""
    a32 = a.float()
    return (c.float() - a32.mT @ a32).to(c.dtype)


def gemm_update(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """``c - bᵀ a`` in f32, cast to ``c.dtype`` (the Cholesky dgemm tile)."""
    return (c.float() - b.float().mT @ a.float()).to(c.dtype)


def trsm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a⁻ᵀ b`` with ``a`` upper-triangular, in f32, cast to ``b.dtype``."""
    return torch.linalg.solve_triangular(
        a.float().mT, b.float(), upper=False).to(b.dtype)
