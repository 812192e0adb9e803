"""Chunked decayed linear attention on Hopper: the kernel's wrapper and its
contract.

:func:`linear_attention` computes RWKV6's (and GLA's, and Mamba2's)
decayed linear attention with the JAX package's contract
(``repro/kernels/linear_attn.py:84``): ``r``/``k``/``w`` are
``(BH, T, dk)``, ``v`` ``(BH, T, dv)`` and the bonus ``u`` ``(H, dk)``,
with ``BH = B x H`` (heads fastest: row ``bh`` takes ``u[bh % H]``); the
output is ``(BH, T, dv)`` in ``r``'s dtype; ``ValueError`` when ``T`` is
not a multiple of ``chunk`` (``ops.linear_attn`` pads) or ``BH`` not of
``H``.  :func:`linear_attention_state` also returns the final
``(BH, dk, dv)`` f32 state, which the kernel writes from the state it
carries and RWKV6's decode continues from.

For CUDA tensors both launch ``linear_attn_kernel`` of
``csrc/linear_attn.cu`` on the current stream; for CPU tensors they run
:func:`.ref.linear_attention_state`, the exact per-step recurrence, and
never the other way round: a CUDA tensor either goes through the kernel
or raises :class:`repro_torch.DeviceError`.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Tuple

import torch

from .. import DeviceError
from . import build, ref
from .block_matmul import DTYPE_CODES, on_card

#: Kernel launches since the last reset (``"linear_attn"``): one per CUDA
#: call, none for the plain version.  Callers clear it before a run they
#: want to count.
LAUNCHES: Counter = Counter()

#: The same launches by ``(BH, T, dk, dv, chunk, dtype)``; cleared with it.
SHAPES: Counter = Counter()

SOURCE = "linear_attn.cu"

#: The kernel's limits (``kMaxChunk`` and ``kMaxDk`` of the source, whose
#: launch refuses more too).
MAX_CHUNK = 64
MAX_DK = 128


def library() -> ctypes.CDLL:
    """The built ``linear_attn.cu`` with its entry points' argument types
    declared."""
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_torch_bound", False):
        lib.linear_attn_launch.argtypes = ([ctypes.c_void_p] * 7
                                           + [ctypes.c_int] * 9
                                           + [ctypes.c_void_p])
        lib.linear_attn_launch.restype = ctypes.c_int
        lib.linear_attn_error_string.argtypes = [ctypes.c_int]
        lib.linear_attn_error_string.restype = ctypes.c_char_p
        lib._repro_torch_bound = True
    return lib


def check_shapes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, chunk: int) -> None:
    """The JAX contract: ``ValueError`` on shapes it does not take."""
    if r.dim() != 3 or v.dim() != 3 or u.dim() != 2:
        raise ValueError(f"bad linear attention shapes r={tuple(r.shape)} "
                         f"v={tuple(v.shape)} u={tuple(u.shape)}")
    bh, t, dk = r.shape
    if k.shape != r.shape or w.shape != r.shape or v.shape[:2] != (bh, t) \
            or u.shape[1] != dk:
        raise ValueError(f"bad linear attention shapes r={tuple(r.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} "
                         f"w={tuple(w.shape)} u={tuple(u.shape)}")
    if chunk <= 0 or t % chunk:
        raise ValueError(f"T={t} not a multiple of chunk={chunk}")
    h = u.shape[0]
    if h == 0 or bh % h:
        raise ValueError(f"BH={bh} not divisible by heads={h}")


def check_operands(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, chunk: int) -> None:
    """Refuses, as :class:`DeviceError`, what the kernel cannot take:
    operands off ``r``'s device, ``k``/``v`` of another dtype than ``r``'s,
    any operand not f32 or bf16 or not contiguous, a chunk above
    :data:`MAX_CHUNK`, ``dk`` above :data:`MAX_DK`, or sizes past the
    kernel's 32-bit arguments."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    for name, t in named:
        if t.device != r.device:
            raise DeviceError(f"linear_attn: {name} is on {t.device}, not "
                              f"{r.device}")
        if t.dtype not in DTYPE_CODES:
            raise DeviceError(f"linear_attn: {name} must be float32 or "
                              f"bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise DeviceError(f"linear_attn: {name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise DeviceError(f"linear_attn: {name} is {t.dtype}, r is "
                              f"{r.dtype}")
    bh, t_len, dk = r.shape
    if chunk > MAX_CHUNK or dk > MAX_DK:
        raise DeviceError(f"linear_attn: chunk {chunk} / dk {dk} exceed the "
                          f"kernel's {MAX_CHUNK} / {MAX_DK}")
    if max(bh, t_len, v.shape[2]) >= 2 ** 31 or v.shape[2] > 16 * 65535:
        raise DeviceError(f"linear_attn: r {tuple(r.shape)} / v "
                          f"{tuple(v.shape)} exceed the kernel's grid")


def launch(lib: ctypes.CDLL, r: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           out: torch.Tensor, state: torch.Tensor, chunk: int) -> None:
    """One launch into ``out`` and ``state`` on the current stream;
    operands are checked by the caller."""
    bh, t_len, dk = r.shape
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.linear_attn_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), bh, t_len, dk, v.shape[2],
        u.shape[0], chunk, DTYPE_CODES[r.dtype], DTYPE_CODES[w.dtype],
        DTYPE_CODES[u.dtype], stream)
    if rc != 0:
        msg = lib.linear_attn_error_string(rc).decode(errors="replace")
        raise DeviceError(f"linear_attn kernel launch failed at r "
                          f"{tuple(r.shape)} v {tuple(v.shape)} chunk "
                          f"{chunk}: {msg} (cudaError {rc})")


def linear_attention_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, u: torch.Tensor, *,
                           chunk: int = 32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (BH, T, dv) in r's dtype, final state (BH, dk, dv) f32)``,
    from a zero state.  ``T`` must be a multiple of ``chunk``."""
    check_shapes(r, k, v, w, u, chunk)
    if not on_card("linear_attn", r):
        return ref.linear_attention_state(r, k, v, w, u)
    check_operands(r, k, v, w, u, chunk)
    lib = library()
    bh, t_len, dk = r.shape
    dv = v.shape[2]
    out = torch.empty((bh, t_len, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    launch(lib, r, k, v, w, u, out, state, chunk)
    LAUNCHES["linear_attn"] += 1
    SHAPES[(bh, t_len, dk, dv, chunk, str(r.dtype))] += 1
    return out, state


def linear_attention(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, *,
                     chunk: int = 32) -> torch.Tensor:
    """``r``/``k``/``w`` ``(BH, T, dk)``, ``v`` ``(BH, T, dv)``, ``u``
    ``(H, dk)``: the output alone, the JAX kernel's contract."""
    return linear_attention_state(r, k, v, w, u, chunk=chunk)[0]
