"""Step-commit of the lockstep scan: the Hopper kernel and its plain version.

Every step of the candidate-axis scan (:mod:`repro_torch.core.torchsim`)
ends in the same commit over the ``[P, S, B]`` lane-last state: pick the
first free slot of each lane's dispatch pool (first-minimum tie-break, like
the reference heap), push that slot's clock to the task's end time, and
fold the busy/seen per-pool accumulators.

:func:`step_commit` launches the CUDA kernel ``csrc/lockstep_step.cu`` for
CUDA tensors; it replaces the Pallas TPU kernel
``repro/kernels/lockstep_step.py::step_commit``.  For CPU tensors it runs
:func:`step_commit_ref`, the plain PyTorch version of the same function,
and never the other way round: a CUDA tensor either goes through the
kernel or raises :class:`repro_torch.DeviceError`.  The two are
bit-identical (no multiply, hence no FMA contraction; the same NaN rules).

Both update ``clocks``, ``busy`` and ``seen`` in place and return ``end``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import DeviceError
from . import build

#: Kernel launches since the last reset: one per CUDA call, none for the
#: plain version.  Callers reset it to 0 before a run they want to count.
LAUNCHES = 0

#: The same launches by ``(P, S, B)`` shape; cleared with ``LAUNCHES``.
SHAPES: Counter = Counter()

SOURCE = "lockstep_step.cu"


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


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if not getattr(lib, "_repro_torch_bound", False):
        fn = lib.step_commit_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.step_commit_error_string.argtypes = [ctypes.c_int]
        lib.step_commit_error_string.restype = ctypes.c_char_p
        lib._repro_torch_bound = True
    return lib


def _check(clocks, busy, seen, p, rt, base, live) -> None:
    """Refuses what the kernel cannot take, as :class:`DeviceError`: on
    CUDA tensors the sweep must fail, not move to the host."""
    if clocks.dim() != 3:
        raise DeviceError(f"clocks must be [P, S, B], got "
                          f"{tuple(clocks.shape)}")
    P, S, B = clocks.shape
    want = {"clocks": (clocks, torch.float64, (P, S, B)),
            "busy": (busy, torch.float64, (P, B)),
            "seen": (seen, torch.bool, (P, B)),
            "p": (p, torch.int64, (B,)),
            "rt": (rt, torch.float64, (B,)),
            "base": (base, torch.float64, (B,)),
            "live": (live, torch.bool, (B,))}
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


def step_commit(clocks: torch.Tensor, busy: torch.Tensor, seen: torch.Tensor,
                p: torch.Tensor, rt: torch.Tensor, base: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """Fused slot-argmin + clock/busy/seen commit for one scan step, in
    place; returns ``end [B]``.  Arguments as :func:`step_commit_ref`.

    CUDA tensors launch the Hopper kernel on the current stream (no
    synchronisation); CPU tensors run :func:`step_commit_ref`."""
    global LAUNCHES
    if clocks.device.type == "cpu":
        return step_commit_ref(clocks, busy, seen, p, rt, base, live)
    if clocks.device.type != "cuda":
        raise DeviceError(f"step_commit has no kernel for device "
                          f"{clocks.device}")
    _check(clocks, busy, seen, p, rt, base, live)
    P, S, B = clocks.shape
    lib = _lib()
    end = torch.empty(B, dtype=torch.float64, device=clocks.device)
    stream = torch.cuda.current_stream(clocks.device).cuda_stream
    rc = lib.step_commit_launch(
        clocks.data_ptr(), busy.data_ptr(), seen.data_ptr(), p.data_ptr(),
        rt.data_ptr(), base.data_ptr(), live.data_ptr(), end.data_ptr(),
        S, B, stream)
    if rc != 0:
        msg = lib.step_commit_error_string(rc).decode(errors="replace")
        raise DeviceError(f"step_commit kernel launch failed: {msg} "
                          f"(cudaError {rc}) at P={P} S={S} B={B}")
    LAUNCHES += 1
    SHAPES[(P, S, B)] += 1
    return end
