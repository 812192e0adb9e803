"""Chunked decayed linear attention on Hopper: the kernels' wrapper and its
contract.

:func:`linear_attention` computes RWKV6's (and GLA's, and Mamba2's)
decayed linear attention with the JAX package's contract
(``repro/kernels/linear_attn.py:84``): ``r``/``k``/``w`` are
``(BH, T, dk)``, ``v`` ``(BH, T, dv)`` and the bonus ``u`` ``(H, dk)``,
with ``BH = B x H`` (heads fastest: row ``bh`` takes ``u[bh % H]``); the
output is ``(BH, T, dv)`` in ``r``'s dtype; ``ValueError`` when ``T`` is
not a multiple of ``chunk`` (``ops.linear_attn`` pads) or ``BH`` not of
``H``.  :func:`linear_attention_state` also returns the final
``(BH, dk, dv)`` f32 state, which the kernels write from the state they
carry and RWKV6's decode continues from.

For CUDA tensors it launches one of two kernels on the current stream,
chosen by :func:`kernel_for` from the widths and the chunk alone:
``dk = dv = 64`` at a chunk in :data:`SUBCHUNK_CHUNKS` (RWKV6's heads)
goes to ``csrc/linear_attn_tc.cu`` (``"subchunk"``: chunks in parallel,
the decay factored at sub-chunks of 16, bf16 products on tensor cores),
every other call to ``csrc/linear_attn.cu`` (``"serial"``: the first
design, chunks one after another).  This is a fixed routing rule, not a
fallback: a call the chosen kernel refuses raises and is never retried
on the other.  For CPU tensors it runs :func:`.ref.linear_attention_state`,
the exact per-step recurrence, and never the other way round: a CUDA
tensor either goes through a kernel or raises
:class:`repro_torch.DeviceError`.

A launch costs the host little: the operand checks are one expression
(the precise refusal is worked out only when it fails), each library is
bound once and held here, the stream is read by PyTorch's raw
current-stream call, and the arguments go to the kernel as one packed
block.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from collections import Counter
from typing import Dict, Tuple

import torch

from .. import DeviceError
from . import build, ref
from .block_matmul import (DTYPE_CODES, current_stream, on_card,
                           refuse_grad)

#: Wrapper calls that launched a kernel since the last reset
#: (``"linear_attn"``): one per CUDA call, none for the plain version.
#: Callers clear it before a run they want to count.
LAUNCHES: Counter = Counter()

#: The same calls by ``(BH, T, dk, dv, chunk, dtype)``; cleared with it.
SHAPES: Counter = Counter()

#: The same calls by the kernel that ran (:func:`kernel_for`'s
#: ``"subchunk"`` or ``"serial"``); cleared with it.
VARIANTS: Counter = Counter()

#: Makes each launch's update of ``LAUNCHES``, ``SHAPES`` and
#: ``VARIANTS`` one step for threads that launch at once.
COUNT_LOCK = threading.Lock()

SOURCE = "linear_attn.cu"
SOURCE_TC = "linear_attn_tc.cu"

#: The serial kernel's limits (``kMaxChunk`` and ``kMaxDk`` of its
#: source, whose launch refuses more too).
MAX_CHUNK = 64
MAX_DK = 128

#: The widths and chunks the sub-chunked kernel takes (``kD`` of its
#: source; the chunk a multiple of its 16-step sub-chunks).
SUBCHUNK_WIDTH = 64
SUBCHUNK_CHUNKS = (16, 32, 64)

#: Both sources' packed launch arguments, ``LinearAttnArgs``: pointers
#: ``r, k, v, w, u, out, state, scratch, stream``, then 64-bit ``BH, T,
#: dk, dv, H, chunk, dtype, w_dtype, u_dtype``.
LINEAR_ARGS = struct.Struct("@9P9q")

#: The bound builds, by source, each built and bound by its first launch.
_CACHED: Dict[str, ctypes.CDLL] = {}


def kernel_for(dtype: torch.dtype, dk: int, dv: int, chunk: int) -> str:
    """The kernel a CUDA call runs: ``"subchunk"`` at ``dk = dv =``
    :data:`SUBCHUNK_WIDTH` and a chunk in :data:`SUBCHUNK_CHUNKS`, else
    ``"serial"``.  f32 takes the sub-chunked kernel too: only bf16
    products go to the tensor cores, but its f32 FMAs still beat the
    serial kernel (46 against 227 µs at (32, 512, 64, 64), chunk 64, on
    an H100 80GB HBM3 at 700 W; ``chip_smoke.py``'s f32 timing)."""
    return ("subchunk" if dk == SUBCHUNK_WIDTH and dv == SUBCHUNK_WIDTH
            and chunk in SUBCHUNK_CHUNKS else "serial")


def scratch_floats(lib: ctypes.CDLL, bh: int, t_len: int,
                   chunk: int) -> int:
    """The f32 scratch that ``lib``, a bound build of the sub-chunked
    kernel, needs: ``BH x T/chunk`` times the floats its source keeps for
    a chunk (``linear_attn_tc_scratch_floats_per_chunk``, read by
    :func:`bind`)."""
    return bh * (t_len // chunk) * lib.scratch_floats_per_chunk


def bind(lib: ctypes.CDLL, prefix: str) -> ctypes.CDLL:
    """``lib`` with ``<prefix>_launch``, ``<prefix>_args_bytes`` and
    ``<prefix>_error_string`` declared and its packed-argument size
    checked; both sources share them.  The sub-chunked build's scratch a
    chunk is read once, into ``lib.scratch_floats_per_chunk``.  Marked on
    the object under :data:`build.BIND_LOCK`, so each library is bound
    once."""
    with build.BIND_LOCK:
        if not getattr(lib, "_repro_torch_bound", False):
            launch_fn = getattr(lib, f"{prefix}_launch")
            launch_fn.argtypes = [ctypes.c_char_p]
            launch_fn.restype = ctypes.c_int
            size = getattr(lib, f"{prefix}_args_bytes")
            size.argtypes = []
            size.restype = ctypes.c_int
            if size() != LINEAR_ARGS.size:
                raise DeviceError(f"{prefix}_args_bytes() is {size()}, but "
                                  f"{LINEAR_ARGS.size} bytes are packed")
            err = getattr(lib, f"{prefix}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            if prefix == "linear_attn_tc":
                per_chunk = lib.linear_attn_tc_scratch_floats_per_chunk
                per_chunk.argtypes = []
                per_chunk.restype = ctypes.c_int
                lib.scratch_floats_per_chunk = per_chunk()
            lib._repro_torch_bound = True
    return lib


def bind_serial(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``linear_attn.cu``, bound."""
    return bind(lib, "linear_attn")


def bind_subchunk(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``linear_attn_tc.cu``, bound."""
    return bind(lib, "linear_attn_tc")


def library(variant: str = "serial") -> ctypes.CDLL:
    """The bound build of ``variant``'s source, built by the first call."""
    lib = _CACHED.get(variant)
    if lib is None:
        if variant == "subchunk":
            lib = build.load(SOURCE_TC, bind=bind_subchunk)
        else:
            lib = build.load(SOURCE, bind=bind_serial)
        _CACHED[variant] = lib
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
    """Refuses, as :class:`DeviceError`, what the kernels cannot take:
    operands off ``r``'s device, ``k``/``v`` of another dtype than ``r``'s,
    any operand not f32 or bf16 or not contiguous, sizes past the kernels'
    32-bit arguments and grids, and for the serial kernel a chunk above
    :data:`MAX_CHUNK` or ``dk`` above :data:`MAX_DK`."""
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
    dv = v.shape[2]
    if kernel_for(r.dtype, dk, dv, chunk) == "serial" and (
            chunk > MAX_CHUNK or dk > MAX_DK):
        raise DeviceError(f"linear_attn: chunk {chunk} / dk {dk} exceed the "
                          f"kernel's {MAX_CHUNK} / {MAX_DK}")
    if max(bh, t_len, dv) >= 2 ** 31 or dv > 16 * 65535 \
            or t_len // chunk > 65535:
        raise DeviceError(f"linear_attn: r {tuple(r.shape)} / v "
                          f"{tuple(v.shape)} exceed the kernel's grid")


def takes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor, chunk: int) -> bool:
    """The fast form of :func:`check_operands`: True when the kernels take
    the operands (shapes already checked by :func:`check_shapes`)."""
    dt, dev = r.dtype, r.device
    bh, t_len, dk = r.shape
    dv = v.shape[2]
    return (dt in DTYPE_CODES and k.dtype is dt and v.dtype is dt
            and w.dtype in DTYPE_CODES and u.dtype in DTYPE_CODES
            and k.device == dev and v.device == dev and w.device == dev
            and u.device == dev
            and r.is_contiguous() and k.is_contiguous()
            and v.is_contiguous() and w.is_contiguous()
            and u.is_contiguous()
            and (kernel_for(dt, dk, dv, chunk) == "subchunk"
                 or (chunk <= MAX_CHUNK and dk <= MAX_DK))
            and max(bh, t_len, dv) < 2 ** 31 and dv <= 16 * 65535
            and t_len // chunk <= 65535)


def launch(lib: ctypes.CDLL, variant: str, r: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           out: torch.Tensor, state: torch.Tensor, scratch: int,
           chunk: int) -> None:
    """One launch of ``variant``'s kernel from ``lib`` into ``out`` and
    ``state`` on the current stream; ``scratch`` is the address of the
    sub-chunked kernel's f32 scratch (0 for the serial kernel).  Operands
    are checked by the caller."""
    bh, t_len, dk = r.shape
    prefix = "linear_attn_tc" if variant == "subchunk" else "linear_attn"
    rc = getattr(lib, f"{prefix}_launch")(LINEAR_ARGS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), scratch, current_stream(r), bh,
        t_len, dk, v.shape[2], u.shape[0], chunk, DTYPE_CODES[r.dtype],
        DTYPE_CODES[w.dtype], DTYPE_CODES[u.dtype]))
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode(
            errors="replace")
        raise DeviceError(f"linear_attn {variant} kernel launch failed at r "
                          f"{tuple(r.shape)} v {tuple(v.shape)} chunk "
                          f"{chunk}: {msg} (cudaError {rc})")


def linear_attention_state(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           w: torch.Tensor, u: torch.Tensor, *,
                           chunk: int = 32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (BH, T, dv) in r's dtype, final state (BH, dk, dv) f32)``,
    from a zero state.  ``T`` must be a multiple of ``chunk``."""
    check_shapes(r, k, v, w, u, chunk)
    refuse_grad("linear_attn", r, k, v, w, u)
    if not on_card("linear_attn", r):
        return ref.linear_attention_state(r, k, v, w, u)
    if not takes(r, k, v, w, u, chunk):
        check_operands(r, k, v, w, u, chunk)
        raise DeviceError("linear_attn: the kernels refuse these operands")
    bh, t_len, dk = r.shape
    dv = v.shape[2]
    variant = kernel_for(r.dtype, dk, dv, chunk)
    lib = library(variant)
    out = torch.empty((bh, t_len, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    scratch = None
    if variant == "subchunk":
        scratch = torch.empty(scratch_floats(lib, bh, t_len, chunk),
                              dtype=torch.float32, device=r.device)
    launch(lib, variant, r, k, v, w, u, out, state,
           0 if scratch is None else scratch.data_ptr(), chunk)
    with COUNT_LOCK:
        LAUNCHES["linear_attn"] += 1
        SHAPES[bh, t_len, dk, dv, chunk, r.dtype] += 1
        VARIANTS[variant] += 1
    return out, state


def linear_attention(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, *,
                     chunk: int = 32) -> torch.Tensor:
    """``r``/``k``/``w`` ``(BH, T, dk)``, ``v`` ``(BH, T, dv)``, ``u``
    ``(H, dk)``: the output alone, the JAX kernel's contract."""
    return linear_attention_state(r, k, v, w, u, chunk=chunk)[0]
