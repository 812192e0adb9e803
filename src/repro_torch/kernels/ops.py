"""Public wrappers around the tile kernels, with the JAX package's contracts.

The tensor's device picks the route, as in :mod:`repro_torch.core.torchsim`:
CUDA tensors launch the Hopper kernels, CPU tensors run their plain
versions.  :func:`matmul` pads its operands to the kernel's block contract
and slices the result back (``repro/kernels/ops.py:26-56``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .block_matmul import block_matmul, gemm_update_tile
from .cholesky_tiles import syrk_tile, trsm_tile


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
