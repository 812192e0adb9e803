"""Step-commit of the lockstep scan: the Hopper kernel and its plain version.

Every step of the candidate-axis scan (:mod:`repro_torch.core.torchsim`)
ends in the same commit over the ``[P, S, B]`` lane-last state: pick the
first free slot of each lane's dispatch pool (first-minimum tie-break, like
the reference heap), push that slot's clock to the task's end time, and
fold the busy/seen per-pool accumulators.

:func:`step_commit` launches the CUDA kernel ``csrc/lockstep_step.cu`` for
CUDA tensors; it replaces the Pallas TPU kernel
``repro/kernels/lockstep_step.py::step_commit``.  The kernel splits each
lane's pool across a group of :func:`group_size` threads, which reduce
their first-minima by warp shuffles.  For CPU tensors it runs
:func:`step_commit_ref`, the plain PyTorch version of the same function,
and never the other way round: a CUDA tensor either goes through the
kernel or raises :class:`repro_torch.DeviceError`.  The two are
bit-identical (no multiply, hence no FMA contraction; the same NaN rules;
the same slot chosen).

Both update ``clocks``, ``busy`` and ``seen`` in place and return ``end``.

:func:`step_fused` launches the same source's fused step: one launch runs
one whole step of the torch scan (:func:`repro_torch.core.torchsim._steps`)
for every lane, the commit above among its phases, in place of the plain
body's ~150 PyTorch operations.  Each lane is one block, whose width
the source picks from the lane's rows and pools.  The plain version it
is held to is that body, which the CPU runs; the fused step has no CPU
route of its own.

A commit launch costs the host little: the operand checks are one
expression (the precise refusal is worked out only when it fails), the
cached library is bound once and held here, the stream is read by
PyTorch's raw current-stream call, and the arguments go to the kernel as
one packed block.  A fused step checks its operands in full at every
launch (~30 µs of host time), which a captured step graph pays once.
"""
from __future__ import annotations

import contextlib
import ctypes
import struct
import threading
from collections import Counter
from typing import Iterator, Optional, Tuple

import torch

from .. import DeviceError
from . import build
from .block_matmul import current_stream, on_card, refuse_grad

#: Kernel launches since the last reset: one per CUDA call, none for the
#: plain version; a captured graph's launches count at each replay
#: (:func:`recording`).  Callers reset it to 0 before a run they want to
#: count.
LAUNCHES = 0

#: The same launches by ``(P, S, B)`` shape; cleared with ``LAUNCHES``.
SHAPES: Counter = Counter()

#: Makes each launch's update of ``LAUNCHES`` and ``SHAPES`` one step for
#: threads that launch at once.
COUNT_LOCK = threading.Lock()

#: The tally of the thread's :func:`recording` block, if one is open.
_TALLY = threading.local()

SOURCE = "lockstep_step.cu"

#: The widest thread group a lane's pool is split across (one warp).
MAX_GROUP = 32

#: The launch's packed arguments, ``StepCommitArgs`` of the source:
#: pointers ``clocks, busy, seen, p, rt, base, live, end, stream``, then
#: 64-bit ``S, B``.
STEP_ARGS = struct.Struct("@9P2q")

#: ``B`` at or above this does not fit the kernel's 32-bit thread count.
MAX_LANES = 2 ** 26

#: The fused step's packed arguments, ``StepFusedArgs`` of the source:
#: pointers ``xi, xf, xb, kind_pool, smp_kid``, the state's
#: :data:`FUSED_STATE` and the stream, then 64-bit ``P, S, B, rows, T, G,
#: K, NK, SC, eft``.
FUSED_ARGS = struct.Struct("@22P10q")

#: The scan state a fused step takes (attributes of
#: ``torchsim._State``), in the packed block's order: the first four it
#: only reads, the others it updates in place.
FUSED_STATE = ("cohort", "own", "ran", "gone", "clocks", "ready",
               "placement", "busy", "seen", "makespan", "prev_rt", "prev_tb",
               "div", "npred", "key", "t")

#: The cached build of ``lockstep_step.cu``, bound by the first launch.
_CACHED: Optional[ctypes.CDLL] = None

_F64, _I64, _I32, _BOOL = (torch.float64, torch.int64, torch.int32,
                           torch.bool)


def group_size(S: int) -> int:
    """The threads the kernel splits a pool of ``S`` slots across: the
    power of two at or above ``S``, at most :data:`MAX_GROUP`
    (``group_for`` of the source)."""
    g = 1
    while g < S and g < MAX_GROUP:
        g *= 2
    return g


def step_commit_ref(clocks: torch.Tensor, busy: torch.Tensor,
                    seen: torch.Tensor, p: torch.Tensor, rt: torch.Tensor,
                    base: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch step-commit (the kernel's reference), in place.

    ``clocks [P, S, B]`` f64, ``busy [P, B]`` f64, ``seen [P, B]`` bool;
    per lane ``p`` (pool id, ``0 <= p < P``), ``rt`` (ready time),
    ``base`` (cost) and ``live``, all ``[B]``.  Returns ``end [B]``,
    ``max(rt, tmin) + base`` whether or not the lane is live."""
    B = clocks.shape[2]
    aB = torch.arange(B, device=clocks.device)
    cl = clocks[p, :, aB]                               # [B, S]
    s = torch.argmin(cl, dim=1)                         # first minimum
    tmin = cl[aB, s]
    start = torch.maximum(rt, tmin)
    end = start + base
    clocks[p, s, aB] = torch.where(live, end, clocks[p, s, aB])
    busy[p, aB] = busy[p, aB] + torch.where(live, end - start, 0.0)
    seen[p, aB] = seen[p, aB] | live
    return end


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``lockstep_step.cu``) with its entry points'
    argument types declared, its packed-argument sizes checked, its
    group sizes held to :func:`group_size` (the mirror the tests hold the
    kernel's reduction to) at every S up to past a warp; marked on the
    object under :data:`build.BIND_LOCK`, so each library is bound once,
    however many threads load it at once."""
    with build.BIND_LOCK:
        if not getattr(lib, "_repro_torch_bound", False):
            lib.step_commit_launch.argtypes = [ctypes.c_char_p]
            lib.step_commit_launch.restype = ctypes.c_int
            lib.step_commit_args_bytes.argtypes = []
            lib.step_commit_args_bytes.restype = ctypes.c_int
            if lib.step_commit_args_bytes() != STEP_ARGS.size:
                raise DeviceError(f"step_commit_args_bytes() is "
                                  f"{lib.step_commit_args_bytes()}, but "
                                  f"{STEP_ARGS.size} bytes are packed")
            lib.step_commit_group.argtypes = [ctypes.c_int]
            lib.step_commit_group.restype = ctypes.c_int
            for S in range(1, 2 * MAX_GROUP + 2):
                if lib.step_commit_group(S) != group_size(S):
                    raise DeviceError(f"step_commit_group({S}) is "
                                      f"{lib.step_commit_group(S)}, but "
                                      f"group_size({S}) is {group_size(S)}")
            lib.step_fused_launch.argtypes = [ctypes.c_char_p]
            lib.step_fused_launch.restype = ctypes.c_int
            lib.step_fused_args_bytes.argtypes = []
            lib.step_fused_args_bytes.restype = ctypes.c_int
            if lib.step_fused_args_bytes() != FUSED_ARGS.size:
                raise DeviceError(f"step_fused_args_bytes() is "
                                  f"{lib.step_fused_args_bytes()}, but "
                                  f"{FUSED_ARGS.size} bytes are packed")
            lib.step_commit_error_string.argtypes = [ctypes.c_int]
            lib.step_commit_error_string.restype = ctypes.c_char_p
            lib._repro_torch_bound = True
    return lib


def step_library() -> ctypes.CDLL:
    """The cached build of ``lockstep_step.cu``, built and bound by the
    first call and held here."""
    global _CACHED
    if _CACHED is None:
        _CACHED = build.load(SOURCE, bind=bind)
    return _CACHED


def check_operands(clocks, busy, seen, p, rt, base, live) -> None:
    """Refuses, as :class:`DeviceError`, what the kernel cannot take: on
    CUDA tensors the sweep must fail, not move to the host."""
    if clocks.dim() != 3:
        raise DeviceError(f"clocks must be [P, S, B], got "
                          f"{tuple(clocks.shape)}")
    P, S, B = clocks.shape
    want = {"clocks": (clocks, _F64, (P, S, B)),
            "busy": (busy, _F64, (P, B)),
            "seen": (seen, _BOOL, (P, B)),
            "p": (p, _I64, (B,)),
            "rt": (rt, _F64, (B,)),
            "base": (base, _F64, (B,)),
            "live": (live, _BOOL, (B,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != clocks.device:
            raise DeviceError(f"{name} is on {t.device}, clocks on "
                              f"{clocks.device}")
        if t.dtype != dtype:
            raise DeviceError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise DeviceError(f"{name} must have shape {shape}, got "
                              f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise DeviceError(f"{name} must be contiguous")
    if S < 1:
        raise DeviceError("clocks needs at least one slot")
    if S >= 2 ** 31 or B >= MAX_LANES:
        raise DeviceError(f"clocks {tuple(clocks.shape)} is too large for "
                          f"the kernel")


def takes(clocks, busy, seen, p, rt, base, live) -> bool:
    """The fast form of :func:`check_operands`: True when the kernel takes
    the operands (one device, the kernel's dtypes and shapes, contiguous,
    at least one slot, sizes within the kernel's)."""
    if clocks.dim() != 3:
        return False
    P, S, B = clocks.shape
    pb, lane = (P, B), (B,)
    dev = clocks.device
    return (clocks.dtype is _F64 and busy.dtype is _F64
            and seen.dtype is _BOOL and p.dtype is _I64
            and rt.dtype is _F64 and base.dtype is _F64
            and live.dtype is _BOOL
            and busy.shape == pb and seen.shape == pb and p.shape == lane
            and rt.shape == lane and base.shape == lane
            and live.shape == lane
            and busy.device == dev and seen.device == dev
            and p.device == dev and rt.device == dev
            and base.device == dev and live.device == dev
            and clocks.is_contiguous() and busy.is_contiguous()
            and seen.is_contiguous() and p.is_contiguous()
            and rt.is_contiguous() and base.is_contiguous()
            and live.is_contiguous()
            and 1 <= S < 2 ** 31 and B < MAX_LANES)


@contextlib.contextmanager
def recording() -> Iterator[Counter]:
    """Launches this thread makes inside the block are tallied by shape in
    the yielded Counter instead of :data:`LAUNCHES` and :data:`SHAPES`.

    A CUDA graph capture runs the wrapper's Python body once, and the
    kernel then runs at every replay: the graph's runner records the
    capture's launches so, and credits them (:func:`credit`) at every
    replay."""
    prev = getattr(_TALLY, "shapes", None)
    tally: Counter = Counter()
    _TALLY.shapes = tally
    try:
        yield tally
    finally:
        _TALLY.shapes = prev


def credit(shapes: Counter, times: int = 1) -> None:
    """Count ``times`` runs of the launches ``shapes`` (a
    :func:`recording` tally) in :data:`LAUNCHES` and :data:`SHAPES`."""
    global LAUNCHES
    with COUNT_LOCK:
        LAUNCHES += times * sum(shapes.values())
        for shape, n in shapes.items():
            SHAPES[shape] += times * n


def step_commit(clocks: torch.Tensor, busy: torch.Tensor, seen: torch.Tensor,
                p: torch.Tensor, rt: torch.Tensor, base: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """Fused slot-argmin + clock/busy/seen commit for one scan step, in
    place; returns ``end [B]``.  Arguments as :func:`step_commit_ref`.

    CUDA tensors launch the Hopper kernel on the current stream (no
    synchronisation); CPU tensors run :func:`step_commit_ref`."""
    refuse_grad("step_commit", clocks, busy, seen, p, rt, base, live)
    if not on_card("step_commit", clocks):
        return step_commit_ref(clocks, busy, seen, p, rt, base, live)
    if not takes(clocks, busy, seen, p, rt, base, live):
        check_operands(clocks, busy, seen, p, rt, base, live)
        raise DeviceError("step_commit: the kernel refuses these operands")
    P, S, B = clocks.shape
    lib = _CACHED or step_library()
    end = torch.empty_like(rt)
    rc = lib.step_commit_launch(STEP_ARGS.pack(
        clocks.data_ptr(), busy.data_ptr(), seen.data_ptr(), p.data_ptr(),
        rt.data_ptr(), base.data_ptr(), live.data_ptr(), end.data_ptr(),
        current_stream(clocks), S, B))
    if rc:
        msg = lib.step_commit_error_string(rc).decode(errors="replace")
        raise DeviceError(f"step_commit kernel launch failed: {msg} "
                          f"(cudaError {rc}) at P={P} S={S} B={B}")
    _count((P, S, B))
    return end


def _count(shape: Tuple[int, int, int]) -> None:
    """One launch at ``shape``: in the thread's :func:`recording` tally if
    one is open, else in :data:`LAUNCHES` and :data:`SHAPES`."""
    global LAUNCHES
    tally = getattr(_TALLY, "shapes", None)
    if tally is not None:
        tally[shape] += 1
        return
    with COUNT_LOCK:
        LAUNCHES += 1
        SHAPES[shape] += 1


def fused_dims(xi: torch.Tensor, xf: torch.Tensor, xb: torch.Tensor, state,
               kind_pool: torch.Tensor, smp_kid: torch.Tensor,
               K: int) -> Tuple[int, ...]:
    """``(P, S, B, rows, T, G, K, NK, SC)`` of a fused step's operands, or
    a :class:`DeviceError` naming the first operand the kernel cannot
    take: off the state's device, of another dtype or shape than the
    scan's (``torchsim._State``, the packed blocks of ``torchsim._pack``),
    not contiguous, or of sizes past the kernel's."""
    clocks = state.clocks
    for name, t, dims in (("clocks", clocks, 3), ("ready", state.ready, 2),
                          ("xi", xi, 3), ("xf", xf, 3)):
        if t.dim() != dims:
            raise DeviceError(f"{name} must have {dims} dimensions, got "
                              f"{tuple(t.shape)}")
    P, S, B = clocks.shape
    rows = state.ready.shape[0]
    T, WI, G = xi.shape
    NK = xf.shape[1] // 2
    SC = WI - 4 - 2 * K
    lane, pb, rb = (B,), (P, B), (rows, B)
    want = {"xi": (xi, _I64, (T, WI, G)), "xf": (xf, _F64, (T, 2 * NK, G)),
            "xb": (xb, _BOOL, (T, 3 + NK, G)),
            "kind_pool": (kind_pool, _I64, (B, NK)),
            "smp_kid": (smp_kid, _I64, lane)}
    kinds = {"cohort": (_I64, lane), "own": (_BOOL, lane),
             "ran": (_I32, lane), "gone": (_F64, lane),
             "clocks": (_F64, (P, S, B)), "ready": (_F64, rb),
             "placement": (_I32, rb), "busy": (_F64, pb),
             "seen": (_BOOL, pb), "makespan": (_F64, lane),
             "prev_rt": (_F64, lane), "prev_tb": (_I64, lane),
             "div": (_BOOL, lane), "npred": (_I32, rb),
             "key": (_F64, (B, rows)), "t": (_I64, lane)}
    for name in FUSED_STATE:
        want[name] = (getattr(state, name), *kinds[name])
    for name, (t, dtype, shape) in want.items():
        if t.device != clocks.device:
            raise DeviceError(f"{name} is on {t.device}, clocks on "
                              f"{clocks.device}")
        if t.dtype != dtype:
            raise DeviceError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise DeviceError(f"{name} must have shape {shape}, got "
                              f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise DeviceError(f"{name} must be contiguous")
    lim = 2 ** 31
    if min(S, rows, T, G, K, NK) < 1 or SC < 0:
        raise DeviceError(f"the fused step needs a slot, a row, a step, a "
                          f"cohort, an option and a kind, and {4 + 2 * K} "
                          f"int64 rows before the successors: got S={S}, "
                          f"rows={rows}, T={T}, G={G}, K={K}, NK={NK}, "
                          f"WI={WI}")
    if max(P * S, B, rows, T, G) >= lim or max(K, NK, SC) >= 2 ** 20:
        raise DeviceError(f"P={P} S={S} B={B} rows={rows} T={T} G={G} "
                          f"K={K} NK={NK} SC={SC} is too large for the "
                          f"fused step")
    return P, S, B, rows, T, G, K, NK, SC


def step_fused(xi: torch.Tensor, xf: torch.Tensor, xb: torch.Tensor, state,
               kind_pool: torch.Tensor, smp_kid: torch.Tensor, eft: bool,
               K: int) -> None:
    """One whole step of the torch scan for every lane of ``state`` (a
    ``torchsim._State``), in place: one launch of the fused kernel on the
    current stream (no synchronisation), counted as one launch at ``(P,
    S, B)`` like :func:`step_commit`'s.  Arguments as
    ``torchsim._steps``'.

    The plain version is ``torchsim._steps``' body, which the CPU runs: a
    tensor off the card is refused here, as is any operand the kernel
    cannot take (:func:`fused_dims`), before anything is launched."""
    clocks = state.clocks
    refuse_grad("step_fused", xf, clocks, state.ready, state.busy,
                state.key)
    if not on_card("step_fused", clocks):
        raise DeviceError("step_fused runs on the card only; the CPU runs "
                          "torchsim._steps' plain body")
    P, S, B, rows, T, G, K, NK, SC = fused_dims(xi, xf, xb, state,
                                                kind_pool, smp_kid, K)
    lib = _CACHED or step_library()
    rc = lib.step_fused_launch(FUSED_ARGS.pack(
        xi.data_ptr(), xf.data_ptr(), xb.data_ptr(), kind_pool.data_ptr(),
        smp_kid.data_ptr(),
        *(getattr(state, name).data_ptr() for name in FUSED_STATE),
        current_stream(clocks), P, S, B, rows, T, G, K, NK, SC, int(eft)))
    if rc:
        msg = lib.step_commit_error_string(rc).decode(errors="replace")
        raise DeviceError(f"step_fused kernel launch failed: {msg} "
                          f"(cudaError {rc}) at P={P} S={S} B={B} "
                          f"rows={rows} K={K} NK={NK} SC={SC}")
    _count((P, S, B))
