"""Public wrappers around the kernels, with the JAX package's contracts.

The tensor's device picks the route, as in :mod:`repro_torch.core.torchsim`:
CUDA tensors launch the Hopper kernels, CPU tensors run their plain
versions.  :func:`matmul`, :func:`attention` and :func:`linear_attn` pad
their operands to the kernels' block contracts and slice the result back
(``repro/kernels/ops.py:26-102``).  No kernel has a backward: on either
device, a call whose operands autograd would record raises
``NotImplementedError`` before any launch or plain version runs
(``block_matmul.refuse_grad``), as the JAX package cannot differentiate its
Pallas kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .block_matmul import block_matmul, gemm_update_tile
from .cholesky_tiles import syrk_tile, trsm_tile
from .flash_attention import flash_attention
from .linear_attn import linear_attention_state


def _pad_to(x: torch.Tensor, axis: int,
            multiple: int) -> Tuple[torch.Tensor, int]:
    """``x`` zero-padded at the end of ``axis`` to a multiple of
    ``multiple``, and the axis's original size."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, size
    widths = [0, 0] * x.dim()                # F.pad lists the last axis first
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return F.pad(x, widths), size


def matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
           block_n: int = 128, block_k: int = 128) -> torch.Tensor:
    """Padded tiled matmul; falls back to small blocks for small operands."""
    m, k = a.shape
    _, n = b.shape
    block_m = min(block_m, max(8, m))
    block_n = min(block_n, max(8, n))
    block_k = min(block_k, max(8, k))
    a, m0 = _pad_to(a, 0, block_m)
    a, _ = _pad_to(a, 1, block_k)
    b, _ = _pad_to(b, 0, block_k)
    b, n0 = _pad_to(b, 1, block_n)
    out = block_matmul(a, b, block_m=block_m, block_n=block_n,
                       block_k=block_k)
    return out[:m0, :n0]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention with padding.  ``q (BH, T, D)``; ``k``/``v``
    ``(BKV, S, D)``.

    Scales by the true head dim before padding.  Padded keys sit at
    positions ``>= S``, which the causal mask hides from every real query
    when ``T <= S``; without the mask they would take part in the
    softmax, so non-causal inputs whose keys need padding raise
    ``NotImplementedError``, as in the JAX package."""
    t = q.shape[1]
    scale = q.shape[2] ** -0.5
    block_q = min(block_q, max(8, t))
    block_k = min(block_k, max(8, k.shape[1]))
    q, t0 = _pad_to(q, 1, block_q)
    k, s0 = _pad_to(k, 1, block_k)
    v, _ = _pad_to(v, 1, block_k)
    if not causal and k.shape[1] != s0:
        raise NotImplementedError("non-causal padded attention unsupported")
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, block_q=block_q,
                          block_k=block_k)
    return out[:, :t0, :]


def linear_attn_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, *, chunk: int = 32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked decayed linear attention with padding on T, and its final
    ``(BH, dk, dv)`` f32 state.  ``r``/``k``/``w`` ``(BH, T, dk)``, ``v``
    ``(BH, T, dv)``, ``u`` ``(H, dk)``.

    The chunk shrinks to ``min(chunk, max(8, T))``; padded steps have
    ``r = k = v = 0`` and decay ``w = 1`` (log 0), so they neither decay
    nor add to the state."""
    t = r.shape[1]
    chunk = min(chunk, max(8, t))
    r, t0 = _pad_to(r, 1, chunk)
    k, _ = _pad_to(k, 1, chunk)
    v, _ = _pad_to(v, 1, chunk)
    if r.shape[1] != t0:
        w = F.pad(w, (0, 0, 0, r.shape[1] - t0), value=1.0)
    out, state = linear_attention_state(r, k, v, w, u, chunk=chunk)
    return out[:, :t0, :], state


def linear_attn(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *,
                chunk: int = 32) -> torch.Tensor:
    """:func:`linear_attn_state`'s output alone (the JAX package's
    ``ops.linear_attn`` contract)."""
    return linear_attn_state(r, k, v, w, u, chunk=chunk)[0]


def syrk(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c - aᵀ a`` — the Cholesky dsyrk tile."""
    return syrk_tile(a, c)


def trsm(a: torch.Tensor, b: torch.Tensor, *, panel: int = 16) -> torch.Tensor:
    """``a⁻ᵀ b``, ``a`` upper-triangular — the Cholesky dtrsm tile."""
    return trsm_tile(a, b, panel=panel)


def gemm_update(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """``c - bᵀ a`` — the Cholesky dgemm tile, one fused launch of the tiled
    matmul kernel on the card (JAX subtracts after the product)."""
    return gemm_update_tile(a, b, c)
