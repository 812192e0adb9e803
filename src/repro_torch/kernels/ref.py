"""Plain PyTorch versions of the kernels (the correctness contract).

Each function computes the mathematically defined result in f32 with no
tiling, fusion or online accumulation, with the names and contracts of
the JAX package's oracles.  The wrappers in :mod:`.block_matmul`,
:mod:`.cholesky_tiles` and :mod:`.flash_attention` run these for CPU
tensors; on the card only the tests and ``chip_smoke.py`` call them, to
hold the kernels to them.
"""
from __future__ import annotations

from typing import Optional

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
