"""Flash attention on Hopper: the kernel's wrapper and its contract.

:func:`flash_attention` computes online-softmax GQA attention with the
JAX package's contract (``repro/kernels/flash_attention.py:77``): ``q``
is ``(BH, T, D)`` (queries flattened over batch x heads, heads fastest),
``k``/``v`` ``(BKV, S, D)`` with ``BH = BKV * group``; ``ValueError`` on
mismatched shapes, on ``BH % BKV`` and when ``T``/``S`` are not multiples
of ``block_q``/``block_k`` (``ops.attention`` pads); the default scale is
``D**-0.5``.

For CUDA tensors it launches one of two kernels on the current stream,
chosen by :func:`kernel_for` from the dtype and the head width alone:
bf16 at ``D`` in :data:`WGMMA_HEAD_DIMS` goes to
``flash_attention_wgmma_kernel`` of ``csrc/flash_attention_wgmma.cu``
(``wgmma`` products, TMA-fed K/V ring; P rounded to bf16 for the PV
product), every other call to ``flash_attention_kernel`` of
``csrc/flash_attention.cu`` (f32 FMAs).  This is a fixed routing rule,
not a fallback: a call the chosen kernel refuses raises and is never
retried on the other.  For CPU tensors it runs :func:`.ref.attention`,
and never the other way round: a CUDA tensor either goes through a
kernel or raises :class:`repro_torch.DeviceError`.  The block arguments
carry the contract only: both kernels tile 64 query rows by 64 keys and
mask ragged edges themselves.
"""
from __future__ import annotations

import ctypes
import threading
from collections import Counter
from typing import Optional

import torch

from .. import DeviceError
from . import build, ref
from .block_matmul import DTYPE_CODES, on_card, refuse_grad

#: Kernel launches since the last reset (``"flash_attention"``): one per
#: CUDA call, none for the plain version.  Callers clear it before a run
#: they want to count.
LAUNCHES: Counter = Counter()

#: The same launches by ``(BH, BKV, T, S, D, dtype)``; cleared with it.
SHAPES: Counter = Counter()

#: The same launches by the kernel that ran (:func:`kernel_for`'s
#: ``"wgmma"`` or ``"fma"``); cleared with it.
VARIANTS: Counter = Counter()

#: Makes each launch's update of ``LAUNCHES``, ``SHAPES`` and
#: ``VARIANTS`` one step for threads that launch at once.
COUNT_LOCK = threading.Lock()

SOURCE = "flash_attention.cu"
SOURCE_WGMMA = "flash_attention_wgmma.cu"

#: The head widths the ``wgmma`` kernel takes, in bf16 (qwen3 and qwen1.5
#: use 128, gemma2 256).
WGMMA_HEAD_DIMS = (64, 128, 256)

#: The widest head the kernel takes (gemma2's 256; ``kMaxHeadDim`` of the
#: source, whose launch refuses wider heads too).
MAX_HEAD_DIM = 256


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of ``dtype`` and head width ``d`` runs:
    ``"wgmma"`` for bf16 at ``d`` in :data:`WGMMA_HEAD_DIMS`, else
    ``"fma"``."""
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            else "fma")


def _bind(lib: ctypes.CDLL, prefix: str) -> ctypes.CDLL:
    """Declares the argument types of ``<prefix>_launch`` and
    ``<prefix>_error_string``; both sources share the signature.  Marked
    on the object under :data:`build.BIND_LOCK`, so each library is bound
    once."""
    with build.BIND_LOCK:
        if not getattr(lib, "_repro_torch_bound", False):
            fn = getattr(lib, f"{prefix}_launch")
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{prefix}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            lib._repro_torch_bound = True
    return lib


def bind_fma(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``flash_attention.cu``, bound."""
    return _bind(lib, "flash_attention")


def bind_wgmma(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``flash_attention_wgmma.cu``, bound."""
    return _bind(lib, "flash_attention_wgmma")


def library() -> ctypes.CDLL:
    """The built ``flash_attention.cu`` with its entry points' argument
    types declared."""
    return build.load(SOURCE, bind=bind_fma)


def wgmma_library() -> ctypes.CDLL:
    """The built ``flash_attention_wgmma.cu`` with its entry points'
    argument types declared."""
    return build.load(SOURCE_WGMMA, bind=bind_wgmma)


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Refuses, as :class:`DeviceError`, what the kernels cannot take:
    operands off ``q``'s device or of another dtype than ``q``'s, not f32
    or bf16, not contiguous, a head wider than :data:`MAX_HEAD_DIM`,
    sizes past the kernel's 32-bit indices and grid, and, for the
    ``wgmma`` kernel, what TMA cannot read: a base pointer not 16-byte
    aligned or a row stride not a multiple of 16 bytes."""
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
    if kernel_for(q.dtype, d) == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or (t.stride(1) * t.element_size()) % 16:
                raise DeviceError(
                    f"flash_attention: {name} is not 16-byte aligned (base "
                    f"{t.data_ptr():#x}, row stride {t.stride(1)} elements)"
                    f", which the wgmma kernel's TMA loads need")


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, out: torch.Tensor, *, causal: bool, window: int,
           softcap: float, scale: float, variant: str) -> None:
    """One launch of ``variant``'s kernel from ``lib`` into ``out`` on the
    current stream; operands are checked by the caller."""
    prefix = ("flash_attention_wgmma" if variant == "wgmma"
              else "flash_attention")
    bh, t_len, d = q.shape
    bkv, s_len, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, f"{prefix}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bkv,
        t_len, s_len, d, DTYPE_CODES[q.dtype], int(causal), int(window),
        float(softcap), float(scale), stream)
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode(
            errors="replace")
        raise DeviceError(f"flash_attention {variant} kernel launch failed "
                          f"at q {tuple(q.shape)} k {tuple(k.shape)}: {msg} "
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
    refuse_grad("flash_attention", q, k, v)
    if not on_card("flash_attention", q):
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    check_operands(q, k, v)
    variant = kernel_for(q.dtype, d)
    lib = wgmma_library() if variant == "wgmma" else library()
    out = torch.empty_like(q)
    launch(lib, q, k, v, out, causal=causal, window=window, softcap=softcap,
           scale=scale, variant=variant)
    with COUNT_LOCK:
        LAUNCHES["flash_attention"] += 1
        SHAPES[(bh, bkv, t_len, s_len, d, str(q.dtype))] += 1
        VARIANTS[variant] += 1
    return out
