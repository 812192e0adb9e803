"""Tile kernels of the Fig. 4 Cholesky on Hopper: dsyrk and dtrsm.

* :func:`syrk_tile` — ``c - aᵀ a`` for one ``(bs, bs)`` tile, through the
  GEMM kernel of ``csrc/tiles.cu`` with its transposed-A and subtracting
  epilogue (replaces ``repro/kernels/cholesky_tiles.py:34 syrk_tile``).
* :func:`trsm_tile` — ``a⁻ᵀ b`` with ``a`` upper-triangular, through the
  blocked forward-substitution kernel of ``csrc/tiles.cu`` at the caller's
  ``panel``: the diagonal panels' inverses, then per panel a product and
  a trailing update (replaces ``repro/kernels/cholesky_tiles.py:86
  trsm_tile``).

dgemm is :func:`.block_matmul.gemm_update_tile`; dpotrf stays outside any
kernel, as the paper keeps it on the SMP.  CPU tensors run the plain
versions of :mod:`.ref`; CUDA tensors launch the kernel on the caller's
current stream or raise :class:`repro_torch.DeviceError`.
"""
from __future__ import annotations

import threading
from collections import Counter

import torch

from .. import DeviceError
from . import ref
from .block_matmul import (DTYPE_CODES, MAX_DIM, TRSM_ARGS, current_stream,
                           launch_gemm, on_card, raise_launch_error, refuse,
                           refuse_grad, takes, tiles_library)

#: Kernel launches since the last reset, by wrapper (``"syrk_tile"``,
#: ``"trsm_tile"``): one per CUDA call, none for the plain version.
LAUNCHES: Counter = Counter()

#: The same launches by ``(wrapper, bs, n, dtype)``; cleared with it.
SHAPES: Counter = Counter()

#: Makes each launch's update of ``LAUNCHES`` and ``SHAPES`` one step for
#: threads that launch at once.
COUNT_LOCK = threading.Lock()


def syrk_tile(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c - aᵀ a`` for one ``(bs, bs)`` tile, accumulated in f32 and cast
    to ``c.dtype``."""
    bs = a.shape[0]
    if a.shape != c.shape or a.shape != (bs, bs):
        raise ValueError(f"syrk tile shapes {tuple(a.shape)} vs "
                         f"{tuple(c.shape)}")
    refuse_grad("syrk_tile", a, c)
    if not on_card("syrk_tile", a):
        return ref.syrk(a, c)
    if not (c.device == a.device and a.dtype in DTYPE_CODES
            and c.dtype in DTYPE_CODES and a.is_contiguous()
            and c.is_contiguous() and bs < MAX_DIM):
        refuse("syrk_tile", {"a": a, "c": c})
    out = torch.empty_like(c)
    launch_gemm(tiles_library(), a, a, c, out, bs, bs, bs, trans_a=True,
                what="syrk_tile")
    with COUNT_LOCK:
        LAUNCHES["syrk_tile"] += 1
        SHAPES["syrk_tile", bs, bs, a.dtype] += 1
    return out


def trsm_tile(a: torch.Tensor, b: torch.Tensor, *,
              panel: int = 16) -> torch.Tensor:
    """``a⁻ᵀ b`` for one tile, ``a (bs, bs)`` upper-triangular, ``b (bs, n)``,
    in f32 and cast to ``b.dtype``, by blocked forward substitution over
    ``panel`` rows (``bs`` must be a multiple of it, the JAX contract)."""
    bs = a.shape[0]
    if a.shape != (bs, bs) or b.shape[0] != bs:
        raise ValueError(f"trsm tile shapes {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if bs % panel:
        raise ValueError(f"bs={bs} not a multiple of panel={panel}")
    refuse_grad("trsm_tile", a, b)
    if not on_card("trsm_tile", a):
        return ref.trsm(a, b)
    n = b.shape[-1]
    if not (b.dim() == 2 and takes(a, b, bs, n)):
        refuse("trsm_tile", {"a": a, "b": b})
    lib = tiles_library()
    out = torch.empty_like(b)
    rc = lib.tiles_trsm_launch(TRSM_ARGS.pack(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), current_stream(b), bs, n,
        panel, DTYPE_CODES[b.dtype]))
    if rc:
        if not lib.tiles_trsm_fits(bs):
            raise DeviceError(f"trsm_tile: a ({bs}, {bs}) tile does not fit "
                              f"in one block's shared memory")
        raise_launch_error(lib, rc,
                           f"trsm_tile at bs={bs} n={n} panel={panel}")
    with COUNT_LOCK:
        LAUNCHES["trsm_tile"] += 1
        SHAPES["trsm_tile", bs, n, b.dtype] += 1
    return out
