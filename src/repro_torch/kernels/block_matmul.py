"""The paper's ``mxmBlock`` tile: the Hopper GEMM kernel and its wrappers.

:func:`block_matmul` computes ``a @ b`` with f32 accumulation and the
JAX package's contract (``repro/kernels/block_matmul.py:34``): the
contraction must match and every dimension must be a multiple of its
block, else ``ValueError``.  :func:`gemm_update_tile` is the Cholesky
dgemm tile ``c - bᵀ a``, through the same kernel with its transposed-A
and subtracting epilogue.

For CUDA tensors both launch ``gemm_tile_kernel`` of ``csrc/tiles.cu``
on the current stream; for CPU tensors they run the plain versions of
:mod:`.ref`, and never the other way round: a CUDA tensor either goes
through the kernel or raises :class:`repro_torch.DeviceError`.

The kernel's own tile edge is the library's compile-time ``TILE`` (64 for
the cached build); it masks ragged edges, so the block arguments carry
the contract, not the launch geometry.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional

import torch

from .. import DeviceError
from . import build, ref

#: Kernel launches since the last reset, by wrapper (``"block_matmul"``,
#: ``"gemm_update"``): one per CUDA call, none for the plain version.
#: Callers clear it before a run they want to count.
LAUNCHES: Counter = Counter()

#: The same launches by ``(wrapper, M, N, K, dtype)``; cleared with it.
SHAPES: Counter = Counter()

SOURCE = "tiles.cu"

#: The kernel's dtype codes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def tiles_library(library: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """``library`` (a fresh build of ``tiles.cu``) or the cached build,
    with its entry points' argument types declared."""
    lib = build.load(SOURCE) if library is None else library
    if not getattr(lib, "_repro_torch_bound", False):
        lib.tiles_gemm_launch.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.tiles_gemm_launch.restype = ctypes.c_int
        lib.tiles_trsm_launch.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
        lib.tiles_trsm_launch.restype = ctypes.c_int
        lib.tiles_trsm_fits.argtypes = [ctypes.c_int]
        lib.tiles_trsm_fits.restype = ctypes.c_int
        lib.tiles_tile_edge.argtypes = []
        lib.tiles_tile_edge.restype = ctypes.c_int
        lib.tiles_error_string.argtypes = [ctypes.c_int]
        lib.tiles_error_string.restype = ctypes.c_char_p
        lib._repro_torch_bound = True
    return lib


def check_operands(kernel: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Refuses, as :class:`DeviceError`, what the tile kernels cannot take:
    operands off the first one's device, not 2-D, not f32 or bf16, not
    contiguous, or with more than 2**31 - 1 rows or columns."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise DeviceError(f"{kernel}: {name} is on {t.device}, not "
                              f"{device}")
        if t.dim() != 2:
            raise DeviceError(f"{kernel}: {name} must be 2-D, got "
                              f"{tuple(t.shape)}")
        if t.dtype not in DTYPE_CODES:
            raise DeviceError(f"{kernel}: {name} must be float32 or "
                              f"bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise DeviceError(f"{kernel}: {name} must be contiguous")
        if max(t.shape) >= 2 ** 31:
            raise DeviceError(f"{kernel}: {name} is too large, "
                              f"{tuple(t.shape)}")


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tiles_error_string(rc).decode(errors="replace")
        raise DeviceError(f"{what} kernel launch failed: {msg} "
                          f"(cudaError {rc})")


def launch_gemm(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor,
                c: Optional[torch.Tensor], out: torch.Tensor, *, trans_a: bool,
                what: str) -> None:
    """``out = [c -] op(a) @ b`` on the current stream; ``op(a)`` is ``aᵀ``
    when ``trans_a``.  Operands are checked by the caller."""
    M, N = out.shape
    K = a.shape[0] if trans_a else a.shape[1]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib.tiles_gemm_launch(
        a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
        out.data_ptr(), M, N, K, DTYPE_CODES[a.dtype],
        DTYPE_CODES[out.dtype], int(trans_a), int(c is not None), stream)
    raise_on_error(lib, rc, f"{what} at M={M} N={N} K={K}")


def on_card(kernel: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device has
    no kernel and no plain route."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise DeviceError(f"{kernel} has no kernel for device {t.device}")
    return True


def block_matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128,
                 block_n: int = 128, block_k: int = 128, out_dtype=None,
                 library: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """``a @ b`` with f32 accumulation, cast to ``out_dtype or a.dtype``.

    Shapes must be multiples of the block sizes (``ops.matmul`` pads).
    ``library`` is a build of ``tiles.cu`` to launch instead of the cached
    one (the traditional flow's fresh build)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(f"shapes {tuple(a.shape)}x{tuple(b.shape)} not "
                         f"multiples of blocks ({block_m},{block_n},"
                         f"{block_k})")
    out_dtype = out_dtype or a.dtype
    if not on_card("block_matmul", a):
        return ref.matmul(a, b, out_dtype)
    check_operands("block_matmul", {"a": a, "b": b})
    if a.dtype != b.dtype or out_dtype not in DTYPE_CODES:
        raise DeviceError(f"block_matmul: a and b must share a dtype and "
                          f"the output be float32 or bfloat16; got "
                          f"{a.dtype}, {b.dtype} -> {out_dtype}")
    lib = tiles_library(library)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launch_gemm(lib, a, b, None, out, trans_a=False, what="block_matmul")
    LAUNCHES["block_matmul"] += 1
    SHAPES[("block_matmul", m, n, k, str(a.dtype))] += 1
    return out


def gemm_update_tile(a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """``c - bᵀ a``: ``a [K, N]``, ``b [K, M]``, ``c [M, N]``, accumulated
    in f32 and cast to ``c.dtype``; one fused launch on the card."""
    K, N = a.shape
    K2, M = b.shape
    if K != K2 or tuple(c.shape) != (M, N):
        raise ValueError(f"gemm_update shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if not on_card("gemm_update", a):
        return ref.gemm_update(a, b, c)
    check_operands("gemm_update", {"a": a, "b": b, "c": c})
    if a.dtype != b.dtype:
        raise DeviceError(f"gemm_update: a and b must share a dtype, got "
                          f"{a.dtype} and {b.dtype}")
    lib = tiles_library()
    out = torch.empty_like(c)
    launch_gemm(lib, b, a, c, out, trans_a=True, what="gemm_update")
    LAUNCHES["gemm_update"] += 1
    SHAPES[("gemm_update", M, N, K, str(a.dtype))] += 1
    return out
