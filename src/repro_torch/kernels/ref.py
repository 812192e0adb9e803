"""Plain PyTorch versions of the tile kernels (the correctness contract).

Each function computes the mathematically defined result in f32 with no
tiling or fusion, with the names and contracts of the JAX package's
oracles.  The wrappers in :mod:`.block_matmul` and :mod:`.cholesky_tiles`
run these for CPU tensors; on the card only the tests and
``chip_smoke.py`` call them, to hold the kernels to them.
"""
from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` in f32, cast to ``out_dtype or a.dtype``."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


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
