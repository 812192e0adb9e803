"""Tile kernels of the Fig. 4 Cholesky on Hopper: dsyrk and dtrsm.

* :func:`syrk_tile` — ``c - aᵀ a`` for one ``(bs, bs)`` tile, through the
  GEMM kernel of ``csrc/tiles.cu`` with its transposed-A and subtracting
  epilogue (replaces ``repro/kernels/cholesky_tiles.py:34 syrk_tile``).
* :func:`trsm_tile` — ``a⁻ᵀ b`` with ``a`` upper-triangular, through the
  forward-substitution kernel of ``csrc/tiles.cu``, one thread per column
  of ``b`` (replaces ``repro/kernels/cholesky_tiles.py:86 trsm_tile``).

dgemm is :func:`.block_matmul.gemm_update_tile`; dpotrf stays outside any
kernel, as the paper keeps it on the SMP.  CPU tensors run the plain
versions of :mod:`.ref`; CUDA tensors launch the kernel or raise
:class:`repro_torch.DeviceError`.
"""
from __future__ import annotations

from collections import Counter

import torch

from .. import DeviceError
from . import ref
from .block_matmul import (DTYPE_CODES, check_operands, launch_gemm, on_card,
                           raise_on_error, tiles_library)

#: Kernel launches since the last reset, by wrapper (``"syrk_tile"``,
#: ``"trsm_tile"``): one per CUDA call, none for the plain version.
LAUNCHES: Counter = Counter()

#: The same launches by ``(wrapper, bs, n, dtype)``; cleared with it.
SHAPES: Counter = Counter()


def syrk_tile(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c - aᵀ a`` for one ``(bs, bs)`` tile, accumulated in f32 and cast
    to ``c.dtype``."""
    bs = a.shape[0]
    if a.shape != c.shape or tuple(a.shape) != (bs, bs):
        raise ValueError(f"syrk tile shapes {tuple(a.shape)} vs "
                         f"{tuple(c.shape)}")
    if not on_card("syrk_tile", a):
        return ref.syrk(a, c)
    check_operands("syrk_tile", {"a": a, "c": c})
    lib = tiles_library()
    out = torch.empty_like(c)
    launch_gemm(lib, a, a, c, out, trans_a=True, what="syrk_tile")
    LAUNCHES["syrk_tile"] += 1
    SHAPES[("syrk_tile", bs, bs, str(a.dtype))] += 1
    return out


def trsm_tile(a: torch.Tensor, b: torch.Tensor, *,
              panel: int = 16) -> torch.Tensor:
    """``a⁻ᵀ b`` for one tile, ``a (bs, bs)`` upper-triangular, ``b (bs, n)``,
    in f32 and cast to ``b.dtype``.

    ``panel`` keeps the JAX contract (``bs`` must be a multiple of it); the
    Hopper kernel substitutes row by row and does not use it."""
    bs = a.shape[0]
    if tuple(a.shape) != (bs, bs) or b.shape[0] != bs:
        raise ValueError(f"trsm tile shapes {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if bs % panel:
        raise ValueError(f"bs={bs} not a multiple of panel={panel}")
    if not on_card("trsm_tile", a):
        return ref.trsm(a, b)
    check_operands("trsm_tile", {"a": a, "b": b})
    if a.dtype != b.dtype:
        raise DeviceError(f"trsm_tile: a and b must share a dtype, got "
                          f"{a.dtype} and {b.dtype}")
    lib = tiles_library()
    if not lib.tiles_trsm_fits(bs):
        raise DeviceError(f"trsm_tile: a ({bs}, {bs}) tile does not fit in "
                          f"one block's shared memory")
    n = b.shape[1]
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = lib.tiles_trsm_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               bs, n, DTYPE_CODES[b.dtype], stream)
    raise_on_error(lib, rc, f"trsm_tile at bs={bs} n={n}")
    LAUNCHES["trsm_tile"] += 1
    SHAPES[("trsm_tile", bs, n, str(b.dtype))] += 1
    return out
