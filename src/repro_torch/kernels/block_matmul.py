"""The paper's ``mxmBlock`` tile: the Hopper GEMM kernel and its wrappers.

:func:`block_matmul` computes ``a @ b`` with f32 accumulation and the
JAX package's contract (``repro/kernels/block_matmul.py:34``): the
contraction must match and every dimension must be a multiple of its
block, else ``ValueError``.  :func:`gemm_update_tile` is the Cholesky
dgemm tile ``c - bᵀ a``, through the same kernel with its transposed-A
and subtracting epilogue.

For CUDA tensors both launch ``gemm_tile_kernel`` of ``csrc/tiles.cu``
on the caller's current stream; for CPU tensors they run the plain
versions of :mod:`.ref`, and never the other way round: a CUDA tensor
either goes through the kernel or raises :class:`repro_torch.DeviceError`.

The kernel's own tile edge is the library's compile-time ``TILE`` (64 for
the cached build); it masks ragged edges, so the block arguments carry
the contract, not the launch geometry.

A launch costs the host little: the operand checks are one expression
(the precise refusal is worked out only when it fails), the cached
library is bound once and held here, the stream is read by PyTorch's raw
current-stream call, and the counters are keyed by plain tuples.
"""
from __future__ import annotations

import ctypes
import struct
import threading
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

#: Makes each launch's update of ``LAUNCHES`` and ``SHAPES`` one step for
#: threads that launch at once.
COUNT_LOCK = threading.Lock()

SOURCE = "tiles.cu"

#: The kernel's dtype codes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Rows and columns below this fit the kernel's ``int`` indices.
MAX_DIM = 2 ** 31

#: The launches' packed arguments, ``GemmArgs`` and ``TrsmArgs`` of
#: ``csrc/tiles.cu``: pointers (``a, b, c, out, stream`` / ``a, b, out,
#: stream``), then 64-bit ``M, N, K, in_dtype, out_dtype, trans_a, sub`` /
#: ``bs, n, panel, dtype``.  One packed block is one ctypes argument, where
#: a dozen declared arguments cost a conversion each on every launch.
GEMM_ARGS = struct.Struct("@5P7q")
TRSM_ARGS = struct.Struct("@4P4q")

#: The cached build of ``tiles.cu``, bound by the first launch.
_CACHED: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``tiles.cu``) with its entry points' argument
    types declared; marked on the object under :data:`build.BIND_LOCK`,
    so each library is bound once."""
    with build.BIND_LOCK:
        if not getattr(lib, "_repro_torch_bound", False):
            for name in ("tiles_gemm_launch", "tiles_trsm_launch"):
                getattr(lib, name).argtypes = [ctypes.c_char_p]
                getattr(lib, name).restype = ctypes.c_int
            for name, packed in (("tiles_gemm_args_bytes", GEMM_ARGS),
                                 ("tiles_trsm_args_bytes", TRSM_ARGS)):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_int
                if getattr(lib, name)() != packed.size:
                    raise DeviceError(f"{name}() is {getattr(lib, name)()}, "
                                      f"but {packed.size} bytes are packed")
            lib.tiles_trsm_fits.argtypes = [ctypes.c_int]
            lib.tiles_trsm_fits.restype = ctypes.c_int
            lib.tiles_tile_edge.argtypes = []
            lib.tiles_tile_edge.restype = ctypes.c_int
            lib.tiles_error_string.argtypes = [ctypes.c_int]
            lib.tiles_error_string.restype = ctypes.c_char_p
            lib._repro_torch_bound = True
    return lib


def tiles_library(library: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """``library`` (a fresh build of ``tiles.cu``), bound, or else the
    cached build, built and bound by the first call and held here."""
    global _CACHED
    if library is not None:
        return bind(library)
    if _CACHED is None:
        _CACHED = build.load(SOURCE, bind=bind)
    return _CACHED


def current_stream(t: torch.Tensor) -> int:
    """The raw handle of the caller's current stream on ``t``'s card: the
    stream a ``torch.cuda.stream(...)`` context sets, else the default."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_operands(kernel: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Refuses, as :class:`DeviceError`, what the tile kernels cannot take:
    operands off the first one's device, not 2-D, not f32 or bf16, not
    contiguous, or with ``MAX_DIM`` or more rows or columns."""
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
        if max(t.shape) >= MAX_DIM:
            raise DeviceError(f"{kernel}: {name} is too large, "
                              f"{tuple(t.shape)}")


def takes(a: torch.Tensor, b: torch.Tensor, *dims: int) -> bool:
    """The fast form of :func:`check_operands` plus the shared-dtype rule,
    for 2-D ``a`` and ``b`` whose sizes are ``dims``: True when the kernel
    takes them (``b`` on ``a``'s device, one kernel dtype, contiguous,
    every size below ``MAX_DIM``)."""
    return (b.device == a.device and a.dtype is b.dtype
            and a.dtype in DTYPE_CODES and a.is_contiguous()
            and b.is_contiguous()
            and max(dims) < MAX_DIM)


def refuse(kernel: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Raises the :class:`DeviceError` that names why the kernel refuses
    ``tensors`` (the slow path behind :func:`takes`): the first failure of
    :func:`check_operands`, else ``a`` and ``b`` of two dtypes."""
    check_operands(kernel, tensors)
    a, b = tensors["a"], tensors.get("b", tensors["a"])
    raise DeviceError(f"{kernel}: a and b must share a dtype, got "
                      f"{a.dtype} and {b.dtype}")


def raise_launch_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raises the :class:`DeviceError` of a launch that returned ``rc``
    (not 0)."""
    msg = lib.tiles_error_string(rc).decode(errors="replace")
    raise DeviceError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def launch_gemm(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor,
                c: Optional[torch.Tensor], out: torch.Tensor, M: int, N: int,
                K: int, *, trans_a: bool, what: str) -> None:
    """``out = [c -] op(a) @ b`` on the current stream; ``op(a)`` is ``aᵀ``
    when ``trans_a``.  Operands are checked by the caller."""
    rc = lib.tiles_gemm_launch(GEMM_ARGS.pack(
        a.data_ptr(), b.data_ptr(), 0 if c is None else c.data_ptr(),
        out.data_ptr(), current_stream(out), M, N, K, DTYPE_CODES[a.dtype],
        DTYPE_CODES[out.dtype], trans_a, c is not None))
    if rc:
        raise_launch_error(lib, rc, f"{what} at M={M} N={N} K={K}")


def refuse_grad(kernel: str, *operands: torch.Tensor) -> None:
    """``NotImplementedError`` when autograd would record any of
    ``operands``, on either device: the kernels have no backward, and the
    JAX package refuses to differentiate its Pallas kernels too.  Each
    wrapper calls it first, so the plain version is never run in a
    kernel's place to get a gradient; a model that trains routes
    attention through ``attn_impl="chunked"``."""
    if torch.is_grad_enabled() and any(o.requires_grad for o in operands):
        raise NotImplementedError(
            f"{kernel} has no backward: its operands require grad (train "
            f"with attn_impl='chunked', the JAX package's training route)")


def on_card(kernel: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device has
    no kernel and no plain route."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise DeviceError(f"{kernel} has no kernel for device {t.device}")


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
    refuse_grad("block_matmul", a, b)
    if not on_card("block_matmul", a):
        return ref.matmul(a, b, out_dtype)
    if not takes(a, b, m, n, k):
        refuse("block_matmul", {"a": a, "b": b})
    if out_dtype not in DTYPE_CODES:
        raise DeviceError(f"block_matmul: the output must be float32 or "
                          f"bfloat16, got {out_dtype}")
    lib = tiles_library(library)
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    launch_gemm(lib, a, b, None, out, m, n, k, trans_a=False,
                what="block_matmul")
    with COUNT_LOCK:
        LAUNCHES["block_matmul"] += 1
        SHAPES["block_matmul", m, n, k, a.dtype] += 1
    return out


def gemm_update_tile(a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """``c - bᵀ a``: ``a [K, N]``, ``b [K, M]``, ``c [M, N]``, accumulated
    in f32 and cast to ``c.dtype``; one fused launch on the card."""
    K, N = a.shape
    K2, M = b.shape
    if K != K2 or c.shape != (M, N):
        raise ValueError(f"gemm_update shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    refuse_grad("gemm_update", a, b, c)
    if not on_card("gemm_update", a):
        return ref.gemm_update(a, b, c)
    if not (takes(a, b, M, N, K) and c.device == a.device
            and c.dtype in DTYPE_CODES and c.is_contiguous()):
        refuse("gemm_update", {"a": a, "b": b, "c": c})
    out = torch.empty_like(c)
    launch_gemm(tiles_library(), b, a, c, out, M, N, K, trans_a=True,
                what="gemm_update")
    with COUNT_LOCK:
        LAUNCHES["gemm_update"] += 1
        SHAPES["gemm_update", M, N, K, a.dtype] += 1
    return out
