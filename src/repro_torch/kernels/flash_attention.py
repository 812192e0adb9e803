"""Flash attention on Hopper: the kernel's wrapper and its contract.

:func:`flash_attention` computes online-softmax GQA attention with the
JAX package's contract (``repro/kernels/flash_attention.py:77``): ``q``
is ``(BH, T, D)`` (queries flattened over batch x heads, heads fastest),
``k``/``v`` ``(BKV, S, D)`` with ``BH = BKV * group``; ``ValueError`` on
mismatched shapes, on ``BH % BKV`` and when ``T``/``S`` are not multiples
of ``block_q``/``block_k`` (``ops.attention`` pads); the default scale is
``D**-0.5``.

For CUDA tensors it launches ``flash_attention_kernel`` of
``csrc/flash_attention.cu`` on the current stream; for CPU tensors it
runs :func:`.ref.attention`, and never the other way round: a CUDA tensor
either goes through the kernel or raises :class:`repro_torch.DeviceError`.
The block arguments carry the contract only: the kernel's own tile is 64
query rows by 64 keys and it masks ragged edges itself.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from .. import DeviceError
from . import build, ref
from .block_matmul import DTYPE_CODES, on_card

#: Kernel launches since the last reset (``"flash_attention"``): one per
#: CUDA call, none for the plain version.  Callers clear it before a run
#: they want to count.
LAUNCHES: Counter = Counter()

#: The same launches by ``(BH, BKV, T, S, D, dtype)``; cleared with it.
SHAPES: Counter = Counter()

SOURCE = "flash_attention.cu"

#: The widest head the kernel takes (gemma2's 256; ``kMaxHeadDim`` of the
#: source, whose launch refuses wider heads too).
MAX_HEAD_DIM = 256


def library() -> ctypes.CDLL:
    """The built ``flash_attention.cu`` with its entry points' argument
    types declared."""
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_torch_bound", False):
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_torch_bound = True
    return lib


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Refuses, as :class:`DeviceError`, what the kernel cannot take:
    operands off ``q``'s device or of another dtype than ``q``'s, not f32
    or bf16, not contiguous, a head wider than :data:`MAX_HEAD_DIM`, or
    sizes past the kernel's 32-bit indices and grid."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise DeviceError(f"flash_attention: {name} is on {t.device}, "
                              f"not {q.device}")
        if t.dtype != q.dtype:
            raise DeviceError(f"flash_attention: {name} is {t.dtype}, q is "
                              f"{q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise DeviceError(f"flash_attention: operands must be float32 or "
                          f"bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise DeviceError(f"flash_attention: {name} must be contiguous")
    bh, t_len, d = q.shape
    if d > MAX_HEAD_DIM:
        raise DeviceError(f"flash_attention: head dim {d} is wider than the "
                          f"kernel's {MAX_HEAD_DIM}")
    if max(bh, t_len, k.shape[0], k.shape[1]) >= 2 ** 31 \
            or t_len > 64 * 65535:
        raise DeviceError(f"flash_attention: q {tuple(q.shape)} / k "
                          f"{tuple(k.shape)} exceed the kernel's grid")


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, out: torch.Tensor, *, causal: bool, window: int,
           softcap: float, scale: float) -> None:
    """One launch into ``out`` on the current stream; operands are checked
    by the caller."""
    bh, t_len, d = q.shape
    bkv, s_len, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bkv,
        t_len, s_len, d, DTYPE_CODES[q.dtype], int(causal), int(window),
        float(softcap), float(scale), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode(errors="replace")
        raise DeviceError(f"flash_attention kernel launch failed at q "
                          f"{tuple(q.shape)} k {tuple(k.shape)}: {msg} "
                          f"(cudaError {rc})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """``q (BH, T, D)``; ``k``/``v`` ``(BKV, S, D)`` with ``BH = BKV x
    group`` (GQA).  Returns ``(BH, T, D)`` in ``q.dtype``.

    ``T``, ``S`` must be multiples of the block sizes (``ops.attention``
    pads)."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"bad attention shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")
    bh, t_len, d = q.shape
    bkv, s_len, dk = k.shape
    if dk != d or v.shape != k.shape or bkv == 0 or bh % bkv:
        raise ValueError(f"bad attention shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")
    if t_len % block_q or s_len % block_k:
        raise ValueError(f"T={t_len}, S={s_len} not multiples of "
                         f"({block_q},{block_k})")
    scale = scale if scale is not None else d ** -0.5
    if not on_card("flash_attention", q):
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    check_operands(q, k, v)
    lib = library()
    out = torch.empty_like(q)
    launch(lib, q, k, v, out, causal=causal, window=window, softcap=softcap,
           scale=scale)
    LAUNCHES["flash_attention"] += 1
    SHAPES[(bh, bkv, t_len, s_len, d, str(q.dtype))] += 1
    return out
