"""Torch candidate-axis engine: the lockstep sweep as a step loop on a device.

:mod:`repro_torch.core.batchsim` proved the lockstep formulation: every
candidate sharing one :class:`~repro_torch.core.fastsim.FrozenGraph`
advances through one replayed reference event order with per-candidate
state stacked on a candidate ("lane") axis.  This module runs the same
per-step semantics as a Python loop over the steps whose body is a fixed
sequence of tensor operations on the chosen ``device``, with the full
per-candidate state resident there.  On a CUDA device a whole step, for
every lane, is one launch of the hand-written kernel
:func:`repro_torch.kernels.lockstep_step.step_fused`; on the CPU it is
the plain PyTorch body :func:`_plain_step`, whose commit (pool select +
slot argmin + clock/busy/seen update) is
:func:`~repro_torch.kernels.lockstep_step.step_commit`'s plain version.

A lane steps one of two ways, in the same loop:

* **Replayed.**  Its cohort shares one recorded dispatch order; at step
  ``t`` the lane reads the ``t``-th row of that order from the packed
  step inputs.
* **Own order.**  Its cohort has no order (``order=None``): at every step
  the lane pops its own heap minimum on the device — the first minimum of
  ``ready`` over the rows whose predecessors have all run, the rows held
  in heap tie-break order (:func:`_own_xs`) — and gathers that row's
  inputs from its graph's tables.  A dispatch never pushes a key below
  the one it popped, so this is
  :func:`~repro_torch.core.fastsim.simulate_fast`'s order by construction:
  such a lane needs no divergence check and never diverges.

Invariants (shared with the numpy backend unless stated):

* **Lane-last axis convention.**  Per-candidate state is stacked with the
  lane axis *last* — pool free-slot clocks ``[P, S, B]``, task ready times
  ``[n, B]``, placement ids ``[n, B]`` — exactly the batchsim layout, so
  the shared assembly helper (:func:`repro_torch.core.replay.lane_results`)
  serves both.
* **rtol tier, not bit-identity.**  The exact engines replicate the
  reference engine's float ops in the reference order; this engine is
  pinned at the relaxed tier instead: makespans and busy sums within
  :data:`repro_torch.core.replay.TORCH_RTOL` (relative) of the reference,
  placements/pool layouts discrete-identical, and rankings stable under the
  documented tie-break.  The state is float64 end to end.
* **Divergence falls back.**  The same per-step heap-key monotonicity
  check as batchsim runs inside the loop for replayed lanes (carried
  ``prev_key`` per lane); lanes whose popped ``(ready_t, tie_break)`` keys
  ever violate it are flagged and their state is discarded; the replay
  protocol (:mod:`repro_torch.core.replay`) discovers them on the exact
  path or steps them again in their own orders.  A lane of either kind
  that live-dispatches a row the reference would raise on is re-simulated
  through :func:`~repro_torch.core.fastsim.simulate_fast`.
* **Fixed-bucket lane chunking.**  Lanes are evaluated in chunks padded to
  power-of-two widths (``chunk`` caps the bucket — non-power-of-two caps
  round *down* to a power of two); padding lanes replicate a real lane and
  are dropped before assembly.

The multi-graph megabatch (:func:`simulate_torch_many`) serves every graph
family of a sweep in one lane axis: heterogeneous ``(graph, order)``
cohorts, replayed and own-order alike, are padded along the task axis to a
shared ``[T, G, ...]`` step-input block with per-step validity masks,
staged once a call, and each lane gathers its cohort's column on the
device.  The
routing/discovery protocol around it is
:func:`repro_torch.core.replay.simulate_many`.

**The compile cache.**  The JAX engine compiles its scan into one XLA
executable per shape signature (``repro/core/jaxsim.py``, through
``xlacache.CompileCache``).  Here each slice of lanes runs through a
:class:`StepRunner` of :class:`~repro_torch.core.graphcache.CompileCache`,
keyed by its shapes (:func:`_signature`): static buffers for the carried
state and a slice's step inputs, and on the card a CUDA graph of
:data:`STEPS` steps captured once, so that one host call replays
:data:`STEPS` launches of the fused step.  The step inputs are packed
into three cohort-last blocks (:func:`_pack`) and copied into the
runner's buffers once a slice; the task axis is padded to a multiple of
:data:`STEPS` with inert steps, so that one capture serves every slice of
a lane and slot bucket.  Off the card the runner runs its eager body;
``graphs=False`` runs the loop eagerly without a runner, the other side
of an A/B check.

The device is never chosen here: ``device`` defaults to
:func:`repro_torch.default_device` (the card), a missing card raises
:class:`repro_torch.DeviceError`, and so does a kernel that fails to build
or launch.  The CPU runs the engine only when asked (``device="cpu"``).
"""
from __future__ import annotations

import collections
import functools
import hashlib
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import DeviceError, default_device, require_cuda
from .. import tracing
from ..kernels import build as kbuild
from ..kernels import lockstep_step as ls
from ..kernels.lockstep_step import step_commit
from ..testing import faults
from . import graphcache
from .devices import SystemConfig
from .graphcache import CompileCache
from .fastsim import FrozenGraph
# TORCH_RTOL is re-exported here on purpose: it is this engine's tier.
from .replay import (BatchStats, TORCH_RTOL, Layout,  # noqa: F401
                     MAX_RESCUE_ROUNDS, MIN_LOCKSTEP, PruneContext,
                     RESCUE_MIN, ReplayLibrary, lane_results,
                     simulate_grouped, simulate_many)
from .simulator import SimResult

#: Lanes per chunk (the bucket cap) on the per-graph path.  Chunks are
#: padded up to power-of-two widths; non-power-of-two caps round down.
DEFAULT_CHUNK = 64

#: Lane-bucket cap for the multi-graph megabatch: wider than the per-graph
#: default because one loop carries every cohort of the sweep, so the
#: fixed per-step launch overhead amortises over more lanes.
MEGABATCH_CHUNK = 256

#: Megabatch slice working-set target, in f64 clock elements (``P×S×B``),
#: kept from the JAX engine, where it was sized for a CPU's L2 (64 KiB of
#: f64).  Not yet re-derived for the H100.
TARGET_SLICE_ELEMS = 8192

DeviceLike = Union[str, torch.device, None]

#: What torch raises when the card itself fails — a CUDA error or device
#: memory exhausted — turned into DeviceError so it never demotes.
#: (``AcceleratorError`` is missing from older torch releases.)
_CARD_ERRORS = tuple(c for c in (getattr(torch, "AcceleratorError", None),
                                 torch.OutOfMemoryError) if c is not None)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` (default: :func:`repro_torch.default_device`) as a
    :class:`torch.device`; a CUDA device must exist (``DeviceError``)."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"the torch engine runs on 'cuda' or 'cpu', not "
                         f"{dev}")
    return dev


def require_torch() -> None:
    """Fault-injection site of the engine's activation (``fail_torch_import``).

    A fault here is an engine fault, demoted like the reference's: the
    Explorer steps down to ``batch``.  A missing card is not: it is
    :func:`resolve_device`'s :class:`~repro_torch.DeviceError`."""
    if faults.fire("fail_torch_import"):
        raise RuntimeError("injected fault: fail_torch_import")


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= ``n``, clamped to ``[min(8, cap'), cap']``
    where ``cap'`` is ``cap`` rounded *down* to a power of two."""
    cap_p = 1
    while cap_p * 2 <= cap:
        cap_p *= 2
    b = min(8, cap_p)
    while b < n and b * 2 <= cap_p:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# The step loop (one body serves per-graph and megabatch paths)
# ---------------------------------------------------------------------------


def _gather_lane(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[aB, idx]`` for a lane-first ``[B, N]`` table."""
    return torch.gather(table, 1, idx.unsqueeze(1)).squeeze(1)


def _gather_row(state: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``state[rows, aB]`` for a lane-last ``[N, B]`` state."""
    return torch.gather(state, 0, rows.unsqueeze(0)).squeeze(0)


def _set_row(state: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> None:
    """``state[rows, aB] = vals`` in place (one entry per lane)."""
    state.scatter_(0, rows.unsqueeze(0), vals.unsqueeze(0))


def _set_lane(table: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> None:
    """``table[aB, idx] = vals`` in place for a lane-first ``[B, N]``
    table."""
    table.scatter_(1, idx.unsqueeze(1), vals.unsqueeze(1))


#: Rows of the packed step inputs (:func:`_pack`): three cohort-last
#: blocks ``[T, W, G]``, one per dtype, one row per step of a replayed
#: cohort and per row of an own-order cohort's graph (:func:`_own_xs`);
#: each lane reads its cohort's column (``_State.cohort``).  The int64
#: block holds these rows, then ``own_opts`` (K rows), ``par_opts`` (K)
#: and the successors (SC); the bool block these, then ``act`` (NK); the
#: f64 block ``own_cost`` (NK) then ``par_cost`` (NK).
_INT_ROWS = ("r", "tb", "c", "k_first")
_BOOL_ROWS = ("valid", "is_comp", "bad_row")


def _pack(lanes: Dict[str, np.ndarray]
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Step inputs (``[T, G, ...]``; successors ``[T, SC, G]``) as the
    three packed blocks ``(xi, xf, xb)``."""
    def rows(name):
        return lanes[name].transpose(0, 2, 1)           # [T, G, W] -> [T, W, G]

    xi = np.concatenate([lanes[f][:, None, :] for f in _INT_ROWS]
                        + [rows("own_opts"), rows("par_opts"),
                           lanes["succ"]], axis=1)
    xf = np.concatenate([rows("own_cost"), rows("par_cost")], axis=1)
    xb = np.concatenate([lanes[f][:, None, :] for f in _BOOL_ROWS]
                        + [rows("act")], axis=1)
    return xi, xf, xb


class _State:
    """The scan's carried state, lane-last: ``clocks [P, S, B]`` f64,
    ``ready [rows, B]`` f64 and ``placement [rows, B]`` int32 (the last
    row is the dummy row of padding steps), ``busy [P, B]`` f64, ``seen
    [P, B]`` bool, and per lane ``makespan``, ``prev_rt``, ``prev_tb`` and
    ``div``.  For own-order lanes (``own [B]``): ``npred [rows, B]``
    int32, minus the predecessors each row still waits for — 0 puts the
    row on the lane's heap — and 1 once it ran, on rows a lane does not
    have, on the dummy row and on every row of a replayed lane, so that
    such a row never joins the heap; and ``key [B, rows]`` f64
    (lane-first, so that a lane's minimum reduces contiguous memory), a
    row's ready time while it is on the heap and ``inf`` otherwise.  ``t
    [B]`` is each lane's step counter, at which a replayed lane reads its
    step inputs (one a lane, so that the fused step's blocks never share
    a word), and ``cohort [B]`` the column of the step inputs each lane
    reads.  Every step updates the state in place, so that a captured
    graph reads and writes the same buffers at every replay.  A new state
    holds valid values (a graph's warm-up runs on it)."""

    def __init__(self, P: int, S: int, B: int, rows: int,
                 device: torch.device):
        f64 = torch.float64
        self.clocks = torch.zeros((P, S, B), dtype=f64, device=device)
        self.ready = torch.zeros((rows, B), dtype=f64, device=device)
        self.placement = torch.full((rows, B), -1, dtype=torch.int32,
                                    device=device)
        self.busy = torch.zeros((P, B), dtype=f64, device=device)
        self.seen = torch.zeros((P, B), dtype=torch.bool, device=device)
        self.makespan = torch.zeros((B,), dtype=f64, device=device)
        self.prev_rt = torch.full((B,), -torch.inf, dtype=f64, device=device)
        self.prev_tb = torch.full((B,), -1, dtype=torch.int64, device=device)
        self.div = torch.zeros((B,), dtype=torch.bool, device=device)
        self.npred = torch.ones((rows, B), dtype=torch.int32, device=device)
        self.own = torch.zeros((B,), dtype=torch.bool, device=device)
        self.key = torch.full((B, rows), torch.inf, dtype=f64, device=device)
        self.t = torch.zeros((B,), dtype=torch.int64, device=device)
        self.ran = torch.ones((B,), dtype=torch.int32, device=device)
        self.gone = torch.full((B,), torch.inf, dtype=f64, device=device)
        self.cohort = torch.arange(B, device=device)

    def reset(self, clocks: np.ndarray, npred: Optional[torch.Tensor] = None,
              own: Optional[torch.Tensor] = None,
              cohort: Optional[torch.Tensor] = None) -> None:
        """A slice's initial state: ``clocks`` (0 for a lane's slots,
        ``inf`` beyond them), nothing ready, placed, busy or seen; each
        own-order lane's ``npred`` (default: no lane steps its own order);
        each lane's ``cohort`` (default: its own column)."""
        self.clocks.copy_(torch.from_numpy(clocks))
        self.ready.zero_()
        self.placement.fill_(-1)
        self.busy.zero_()
        self.seen.zero_()
        self.makespan.zero_()
        self.prev_rt.fill_(-torch.inf)
        self.prev_tb.fill_(-1)
        self.div.zero_()
        self.t.zero_()
        if cohort is None:
            torch.arange(self.cohort.shape[0], out=self.cohort)
        else:
            self.cohort.copy_(cohort)
        if npred is None:
            self.npred.fill_(1)
            self.own.zero_()
        else:
            self.npred.copy_(npred)
            self.own.copy_(own)
        # the roots are on the heap, ready at 0
        self.key.fill_(torch.inf).masked_fill_(self.npred.T == 0, 0.0)

    def outputs(self) -> Tuple[np.ndarray, ...]:
        """Host copies of ``(div, makespan, busy, seen, placement)``.  Two
        checks add to ``div``, for the exact path to settle: an own-order
        lane that left a row unrun (a cyclic graph: the exact path
        reports the deadlock), and a lane whose makespan is not the
        latest of its finite clocks — every dispatch's end is written to
        a slot, so a commit that wrote nothing cannot pass."""
        with tracing.span("step.readback"):
            clocks = self.clocks
            last = torch.where(torch.isfinite(clocks), clocks,
                               0.0).amax(dim=(0, 1))
            div = self.div | (self.makespan != last) \
                | (self.own & (self.npred <= 0).any(dim=0))
            return tuple(t.to("cpu", copy=True).numpy() for t in (
                div, self.makespan, self.busy, self.seen, self.placement))


def _steps(xi: torch.Tensor, xf: torch.Tensor, xb: torch.Tensor,
           st: _State, kind_pool: torch.Tensor, smp_kid: torch.Tensor,
           eft: bool, K: int, n_steps: Optional[int] = None) -> None:
    """``n_steps`` steps of the scan on ``st`` (default: one per row of
    the blocks), in place; the port of jaxsim's scan body.  On the card
    each step is one launch of the fused kernel
    (:func:`repro_torch.kernels.lockstep_step.step_fused`); on the CPU it
    is :func:`_plain_step`, the plain PyTorch body the kernel is held to
    bit for bit."""
    n_steps = xi.shape[0] if n_steps is None else n_steps
    step = ls.step_fused if ls.on_card("step_fused", st.clocks) \
        else _plain_step
    for _ in range(n_steps):
        step(xi, xf, xb, st, kind_pool, smp_kid, eft, K)


def _plain_step(xi: torch.Tensor, xf: torch.Tensor, xb: torch.Tensor,
                st: _State, kind_pool: torch.Tensor, smp_kid: torch.Tensor,
                eft: bool, K: int) -> None:
    """One step of the scan on ``st``, in place, in PyTorch operations.

    Step inputs are the packed cohort-last blocks of :func:`_pack`
    (staged by :func:`_scan_cohorts`), ``K`` option rows wide; each lane
    reads its cohort's column (``st.cohort``).  A replayed lane reads the
    row of its step counter ``st.t``; per-step ``valid`` masks make the
    task-axis padding inert.  An own-order lane (``st.own``) reads the
    row it pops: the first minimum of ``st.key`` — the ready times of the
    rows on its heap, rows in heap tie-break order, so the first minimum
    is the heap's ``(ready_t, creation index, rank)`` minimum — and is
    valid while its heap holds a row; its dispatch then takes the row off
    the heap and pushes the successors it was the last predecessor of.
    Every operation is a PyTorch operation except the commit,
    :func:`~repro_torch.kernels.lockstep_step.step_commit`."""
    NK = xf.shape[1] // 2
    clocks, ready, placement = st.clocks, st.ready, st.placement
    dummy = ready.shape[0] - 1

    def choose(opts, cost, rt, minc):
        """Vectorised reference `_choose_kind` over all lanes and options
        at once: among the options with a pool, the least key, then
        the least preference (an accelerator before the SMP), then the
        lowest index — the exact engines' strict ``<`` on ``(key,
        pref)`` in annotation order.  ``opts [K, B]``, ``cost [NK, B]``;
        ``minc [P, B]`` is the step's hoisted earliest-free-slot
        reduction.  -1 where no option has a pool."""
        kk = opts.clamp(min=0)
        pi = torch.gather(kind_pool.T, 0, kk)               # [K, B]
        valid = (opts >= 0) & (pi >= 0)
        keyv = torch.maximum(rt, torch.gather(minc, 0, pi.clamp(min=0)))
        if eft:
            keyv = keyv + torch.gather(cost, 0, kk)
        keyv = torch.where(valid, keyv, torch.inf)
        tie = valid & (keyv == keyv.amin(dim=0))
        smp = opts == smp_kid
        tie &= ~(smp & (tie & ~smp).any(dim=0))
        first = tie.to(torch.uint8).argmax(dim=0, keepdim=True)
        return torch.where(tie.any(dim=0), torch.gather(opts, 0, first)[0],
                           -1)

    def row(block, at):
        """``block[at[b], :, st.cohort[b]]`` for every lane ``b``:
        ``[W, B]``."""
        return block.permute(1, 0, 2)[:, at, st.cohort]

    # ---- the row each lane runs: its own heap's minimum, or its
    # cohort's order at the step counter -----------------------------
    kmin, popped = torch.min(st.key, dim=1)
    at = torch.where(st.own, popped, st.t)
    xiu, xfu, xbu = row(xi, at), row(xf, at), row(xb, at)
    r, tbv, c, k_first = xiu[0], xiu[1], xiu[2], xiu[3]
    own_opts, par_opts = xiu[4:4 + K], xiu[4 + K:4 + 2 * K]
    succ = xiu[4 + 2 * K:]                              # [SC, B]
    own_cost, par_cost = xfu[:NK], xfu[NK:]
    valid = torch.where(st.own, kmin < torch.inf, xbu[0])
    is_comp, bad_row, act = xbu[1], xbu[2], xbu[3:]
    rt = _gather_row(ready, r)      # r: dummy row on invalid steps
    # heap-key monotonicity: a replayed lane whose popped (ready_t, tb)
    # key ever fails to strictly increase is not executing its own
    # heap order — flag it (and any lane that live-executes a bad
    # row, below).  An own-order lane pops its heap: a zero-cost row
    # may push an equal ready_t with a smaller tb, which it pops next.
    st.div |= valid & ~st.own & ((rt < st.prev_rt)
                                 | ((rt == st.prev_rt)
                                    & (tbv <= st.prev_tb)))

    # earliest-free slot per (pool, lane), shared by both choose passes
    minc = torch.amin(clocks, dim=1)                    # [P, B]

    # ---- conditional pass-through (per-lane mask) -------------------
    has_cond = (c >= 0) & valid
    cmax = c.clamp(min=0)
    pk_old = _gather_row(placement, cmax).long()        # [B]
    chosen_p = choose(par_opts, par_cost, rt, minc)
    pk = torch.where(pk_old < 0, chosen_p, pk_old)
    _set_row(placement, cmax,
             torch.where(has_cond, pk, pk_old).to(placement.dtype))
    live = (~has_cond | _gather_row(act, pk.clamp(min=0))) & valid

    # ---- dispatch + commit for the lanes executing the row ----------
    k_own = _gather_row(placement, r).long()
    und = k_own < 0
    chosen_o = choose(own_opts, own_cost, rt, minc)
    k = torch.where(is_comp, torch.where(und, chosen_o, k_own), k_first)
    _set_row(placement, r,
             torch.where(is_comp & live & und, k, k_own
                         ).to(placement.dtype))
    st.div |= live & (bad_row | (k < 0))
    kk = k.clamp(min=0)
    p = _gather_lane(kind_pool, kk).clamp(min=0)        # [B]
    base = _gather_row(own_cost, kk)                    # [B]
    end = step_commit(clocks, st.busy, st.seen, p, rt, base, live)
    end_eff = torch.where(live, end, torch.where(valid, rt, 0.0))
    torch.maximum(st.makespan, end_eff, out=st.makespan)
    ready.scatter_reduce_(0, succ, end_eff.unsqueeze(0).expand_as(succ),
                          reduce="amax", include_self=True)
    torch.where(valid, rt, st.prev_rt, out=st.prev_rt)
    torch.where(valid, tbv, st.prev_tb, out=st.prev_tb)
    # ---- the heap of an own-order lane: the row leaves it, each
    # successor waits for one predecessor fewer, and those that wait
    # for none join it at their ready time --------------------------
    ran = torch.where(valid, r, dummy)
    _set_lane(st.key, ran, st.gone)
    _set_row(st.npred, ran, st.ran)
    st.npred.scatter_add_(0, succ, valid.to(torch.int32).unsqueeze(0)
                          .expand_as(succ))
    # a successor not joining keeps inf: it waits, ran, or is the dummy
    st.key.scatter_(1, succ.T, torch.where(
        torch.gather(st.npred, 0, succ) == 0,
        torch.gather(ready, 0, succ), torch.inf).T)
    st.t += 1


#: Steps in one replay of a captured step graph: 32 nodes, one fused step
#: each.  One graph of the whole scan would be captured anew for every
#: task count; 32 steps are captured once for every slice of a lane and
#: slot bucket, and a slice pads by at most 31 inert steps — under 1 % of
#: a 3,584-step matmul slice, 7 % of the 120-step Cholesky one.
STEPS = 32


class StepRunner:
    """One shape signature of the scan, the runner of the compile cache
    (:mod:`repro_torch.core.graphcache`): static buffers for a slice's
    state and step inputs, and the steps over them — on the card a
    captured CUDA graph of :data:`STEPS` steps, on the CPU the eager body
    over the slice's own inputs.

    :meth:`run` copies a slice's initial state and step inputs in,
    replays once every :data:`STEPS` steps, credits the fused-step
    launches recorded at capture at each replay, and copies the results
    out, all under the runner's lock: two threads never share its buffers
    at once.

    ``dims`` is ``(P, S, B, rows, WI, NK, K)``: pools, slots, lanes, state
    rows, int64 block rows, kinds and options.  The step-input buffers
    hold one row per graph row (``rows - 1``, rounded up to
    :data:`STEPS`) — a replayed cohort's steps, and the tables an
    own-order lane gathers its popped row from — and up to ``B`` cohorts:
    a slice's lanes never come from more."""

    def __init__(self, dims: Tuple[int, ...], device: torch.device,
                 eft: bool, cache: CompileCache):
        P, S, B, rows, WI, NK, K = dims
        self.K, self.eft, self.cache = K, eft, cache
        self.state = _State(P, S, B, rows, device)
        self.kind_pool = torch.zeros((B, NK), dtype=torch.int64,
                                     device=device)
        self.smp_kid = torch.zeros((B,), dtype=torch.int64, device=device)
        self.lock = threading.Lock()
        self.graph = None
        self.launches: collections.Counter = collections.Counter()
        self.libraries: Tuple[Tuple[str, None], ...] = ()
        if device.type == "cuda":
            T = -(-(rows - 1) // STEPS) * STEPS

            def block(width, dtype):
                return torch.zeros((T, width, B), dtype=dtype, device=device)

            self.xi = block(WI, torch.int64)
            self.xf = block(2 * NK, torch.float64)
            self.xb = block(len(_BOOL_ROWS) + NK, torch.bool)
            self.libraries = ((ls.SOURCE, None),)
            kbuild.load(ls.SOURCE, bind=ls.bind, store=cache.kernel_store)
            tallies = []

            def body():
                # the warm-up's launches and the capture's are not the
                # path's; the capture's are credited at every replay
                with ls.recording() as tally:
                    _steps(self.xi, self.xf, self.xb, self.state,
                           self.kind_pool, self.smp_kid, eft, K, STEPS)
                tallies.append(tally)

            self.graph = graphcache.capture(body, cache)
            self.launches = tallies[-1]

    def run(self, xi: torch.Tensor, xf: torch.Tensor, xb: torch.Tensor,
            clocks: np.ndarray, kind_pool: torch.Tensor,
            smp_kid: torch.Tensor, npred: Optional[torch.Tensor] = None,
            own: Optional[torch.Tensor] = None,
            cohort: Optional[torch.Tensor] = None
            ) -> Tuple[np.ndarray, ...]:
        """The slice whose packed inputs (``[T, W, G]``, ``T`` a multiple
        of :data:`STEPS`), initial clocks, own-order lanes and cohorts
        (``npred``, ``own``, ``cohort``: :meth:`_State.reset`) are given;
        returns host copies of ``(div, makespan, busy, seen,
        placement)``."""
        T, G = xi.shape[0], xi.shape[2]
        with self.lock:
            self.state.reset(clocks, npred, own, cohort)
            self.kind_pool.copy_(kind_pool)
            self.smp_kid.copy_(smp_kid)
            if self.graph is None:
                _steps(xi, xf, xb, self.state, self.kind_pool, self.smp_kid,
                       self.eft, self.K)
            else:
                self.xi[:T, :, :G].copy_(xi)
                self.xf[:T, :, :G].copy_(xf)
                self.xb[:T, :, :G].copy_(xb)
                replays = T // STEPS
                for _ in range(replays):
                    graphcache.replay(self.graph)
                ls.credit(self.launches, replays)
                self.cache.note_replays(replays)
            return self.state.outputs()


#: The compile cache of callers that name none: process-wide and in
#: memory only, so that fresh Explorers share captured runners.
_DEFAULT_CACHE = CompileCache()


@functools.lru_cache(maxsize=None)
def _code_fingerprint() -> str:
    """Hash of the step loop's and its kernel's sources, part of every
    runner's signature: a runner of an older step must miss."""
    h = hashlib.sha256()
    for path in (Path(__file__), Path(ls.__file__), kbuild.CSRC / ls.SOURCE):
        try:
            h.update(path.read_bytes())
        except OSError:                 # sources unreadable: the
            return "unhashable"         # environment key still applies
    return h.hexdigest()[:16]


def _signature(dims: Tuple[int, ...], device: torch.device,
               eft: bool) -> Tuple:
    """Shape signature of one runner — the compile-cache key body (the
    environment half lives in CompileCache)."""
    return (_code_fingerprint(), "step", str(device), eft, STEPS, dims)


def _load_runner(cc: CompileCache, dims: Tuple[int, ...],
                 device: torch.device, eft: bool) -> StepRunner:
    """The runner for this signature: a memory hit, or one built (and
    captured, on the card) now."""
    return cc.load_or_compile(_signature(dims, device, eft),
                              lambda: StepRunner(dims, device, eft, cc))


# ---------------------------------------------------------------------------
# Per-cohort step inputs
# ---------------------------------------------------------------------------


def _bad_rows(fg: FrozenGraph, kind_pool: Sequence[int]) -> np.ndarray:
    """``bool[n]``: rows whose *execution* would make the reference engine
    raise under this pool template — a compute row with an eligible option
    (pool present) carrying a NaN cost or with no compatible pool at all,
    or a non-compute row whose device has no pool / no cost.

    Whether such a row ever executes in a given lane is runtime state
    (conditional rows are skipped when the parent lands on the SMP), so
    the loop cannot raise eagerly: a lane that *live*-dispatches a bad row
    is flagged and re-routed through the exact fallback, where
    ``simulate_fast`` raises the reference error — or completes, when the
    lane's own event order never reaches the row."""
    kp = np.asarray(kind_pool, dtype=np.int64)
    rows = np.arange(fg.n)
    opts = _dense(fg.dev_indptr, fg.dev_kids, -1, fg.n)
    first = fg.dev_kids[fg.dev_indptr[:-1]]
    eligible = (opts >= 0) & (kp[np.maximum(opts, 0)] >= 0)
    nan = np.isnan(fg.cost[rows[:, None], np.maximum(opts, 0)])
    comp = (eligible & nan).any(axis=1) | ~eligible.any(axis=1)
    other = (kp[first] < 0) | np.isnan(fg.cost[rows, first])
    return np.where(fg.is_compute, comp, other)


def _heap_order(fg: FrozenGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(tb, heap, pos_of)``: each row's heap tie-break scalar (creation
    index, then rank in uid order: ``graph_aux``'s), the rows in that
    order, and each row's position in it."""
    n = fg.n
    rank = np.empty(n, dtype=np.int64)
    rank[np.argsort(fg.uid, kind="stable")] = np.arange(n)
    tb = fg.creation_index.astype(np.int64) * n + rank
    heap = np.argsort(tb, kind="stable")
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[heap] = np.arange(n)
    return tb, heap, pos_of


def _width_of(indptr: np.ndarray) -> int:
    """The longest row of a CSR column, at least 1."""
    return max(1, int(np.diff(indptr).max()) if len(indptr) > 1 else 1)


def _dense(indptr: np.ndarray, values: np.ndarray, fill: int,
           n: int) -> np.ndarray:
    """A CSR column as a dense ``[n, width]`` int64 array, each row's
    entries first and ``fill`` after them (width at least 1)."""
    counts = np.diff(indptr)
    out = np.full((n, _width_of(indptr)), fill, dtype=np.int64)
    rows = np.repeat(np.arange(n), counts)
    out[rows, np.arange(len(values)) - indptr[rows]] = values
    return out


# Per-FrozenGraph cap on memoised (order, kind_pool) -> xs entries (the
# replay library's per-key order cap).
_XS_CACHE_CAP = 32

#: Guards the engine's shared caches: the per-FrozenGraph memos
#: (``fg._torch_caps``, ``fg._torch_xs``) and :data:`_DEV_XS_CACHE`,
#: which sweeps in several threads of one process share.  The lock
#: covers each lookup, eviction and insertion, never the work that builds
#: an entry, so two threads that miss on one key may both build it and
#: the second insert wins.
_CACHE_LOCK = threading.Lock()


def _memo_get(fg: FrozenGraph, attr: str, key: Tuple):
    """``fg``'s memo ``attr`` at ``key``, or None."""
    with _CACHE_LOCK:
        cache = getattr(fg, attr, None)
        return None if cache is None else cache.get(key)


def _memo_put(fg: FrozenGraph, attr: str, key: Tuple, value):
    """Store ``value`` in ``fg``'s memo ``attr`` (created on first use,
    oldest entry evicted at :data:`_XS_CACHE_CAP`); returns ``value``."""
    with _CACHE_LOCK:
        cache = getattr(fg, attr, None)
        if cache is None:
            cache = {}
            setattr(fg, attr, cache)
        if key not in cache and len(cache) >= _XS_CACHE_CAP:
            cache.pop(next(iter(cache)))
        cache[key] = value
    return value


def _pool_caps(fg: FrozenGraph, kind_pool: Sequence[int],
               P: int) -> np.ndarray:
    """``int[P]``: how many rows could *ever* dispatch to each pool —
    computes count toward every eligible pool, non-computes toward their
    device's pool.  Every order a cohort steps holds every row once, so
    this holds for every cohort of the graph and template.

    This bounds the slot axis exactly: slots are claimed in prefix order
    (the commit's first-minimum argmin always prefers the lowest-index
    free slot, and every slot starts free), so a pool that receives at
    most ``m`` dispatches can never touch slot ``m`` or beyond.  Memoised
    per kind_pool beside :func:`_group_xs`."""
    ckey = (tuple(kind_pool), P)
    cached = _memo_get(fg, "_torch_caps", ckey)
    if cached is not None:
        return cached
    opts = _dense(fg.dev_indptr, fg.dev_kids, -1, fg.n)
    opts[~fg.is_compute.astype(bool), 1:] = -1      # the device's pool only
    pools = np.asarray(kind_pool, dtype=np.int64)[np.maximum(opts, 0)]
    cap = np.bincount(pools[(opts >= 0) & (pools >= 0)], minlength=P)
    return _memo_put(fg, "_torch_caps", ckey, cap[:P].astype(np.int64))


def _rows_xs(fg: FrozenGraph, kind_pool: Sequence[int]
             ) -> Dict[str, np.ndarray]:
    """:func:`_group_xs`'s inputs for every row of ``fg``, in row order,
    memoised per pool template on the FrozenGraph (dropped on
    pickling)."""
    ckey = tuple(kind_pool)
    cached = _memo_get(fg, "_torch_rows", ckey)
    if cached is not None:
        return cached
    n = fg.n
    tb, _, _ = _heap_order(fg)
    act_mask = np.zeros((n, len(fg.kinds)), dtype=bool)
    act_mask[np.repeat(np.arange(n), np.diff(fg.act_indptr)),
             fg.act_kids] = True
    opts = _dense(fg.dev_indptr, fg.dev_kids, -1, n)
    cond = fg.cond.astype(np.int64)
    has = cond >= 0
    parent = np.where(has, cond, 0)
    # bad-row flags capture every NaN a live dispatch could reach; scrub
    # the rest so no masked-out lane arithmetic can produce a NaN
    cost = np.nan_to_num(fg.cost)
    xs = {
        "r": np.arange(n, dtype=np.int64),
        "tb": tb,
        "c": cond,
        "is_comp": fg.is_compute.astype(bool),
        "k_first": fg.dev_kids[fg.dev_indptr[:-1]].astype(np.int64),
        "own_opts": opts,
        "own_cost": cost,
        "par_opts": np.where(has[:, None], opts[parent], -1),
        "par_cost": np.where(has[:, None], cost[parent], 0.0),
        "act": act_mask & has[:, None],
        "bad_row": _bad_rows(fg, kind_pool),
        "succ": _dense(fg.succ_indptr, fg.succ_rows, n, n),
    }
    return _memo_put(fg, "_torch_rows", ckey, xs)


def _group_xs(fg: FrozenGraph, order: Sequence[int],
              kind_pool: Sequence[int]) -> Dict[str, np.ndarray]:
    """Per-step inputs shared by every lane of the cohort, in replay order:
    row ids, tie-break scalars, conditional parents, device options and
    cost rows for the row *and* its conditional parent, activation-mask
    rows, bad-dispatch flags (:func:`_bad_rows`), and padded successor
    lists (pad = ``n``, a dummy ready row — remapped to the megabatch dummy
    by :func:`_scan_cohorts`): :func:`_rows_xs` gathered at ``order``.
    Memoised on the FrozenGraph; dropped on pickling."""
    ckey = (tuple(order), tuple(kind_pool))
    cached = _memo_get(fg, "_torch_xs", ckey)
    if cached is not None:
        return cached
    idx = np.asarray(order, dtype=np.int64)
    xs = {k: v[idx] for k, v in _rows_xs(fg, kind_pool).items()}
    return _memo_put(fg, "_torch_xs", ckey, xs)


def _own_xs(fg: FrozenGraph, kind_pool: Sequence[int]
            ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """The tables of an own-order cohort: :func:`_group_xs` over every row
    in heap tie-break order (``graph_aux``'s ``tb``: creation index, then
    rank), each row, conditional parent and successor named by its
    position in that order, so that the first minimum of a lane's ready
    times over the positions is its heap's minimum.  Returns ``(xs,
    pos_of, npred)``: ``xs["r"]`` the positions, ``pos_of[row]`` a row's
    position, ``npred`` minus each position's predecessor count
    (:class:`_State`).  Memoised on the FrozenGraph beside
    :func:`_group_xs`."""
    ckey = tuple(kind_pool)
    cached = _memo_get(fg, "_torch_own", ckey)
    if cached is not None:
        return cached
    n = fg.n
    _, heap, pos_of = _heap_order(fg)
    xs = dict(_group_xs(fg, heap, kind_pool))
    xs["r"] = np.arange(n, dtype=np.int64)
    xs["c"] = np.where(xs["c"] >= 0, pos_of[np.maximum(xs["c"], 0)], -1)
    succ = xs["succ"]
    xs["succ"] = np.where(succ < n, pos_of[np.minimum(succ, n - 1)], n)
    npred = -fg.n_pred[heap].astype(np.int32)
    return _memo_put(fg, "_torch_own", ckey, (xs, pos_of, npred))


# Cohort-last device blocks of a call, memoised across _scan_cohorts calls:
# keyed by device, content (per-cohort graph hash × order × pool template)
# and megabatch dims.  The cap bounds residency, LRU evicts; _CACHE_LOCK
# guards it.
_DEV_XS_CACHE: "collections.OrderedDict[Tuple, Tuple]" = \
    collections.OrderedDict()
_DEV_XS_CACHE_CAP = 16


# ---------------------------------------------------------------------------
# Cohort driver: task-axis padding, chunked lanes, shared step loop
# ---------------------------------------------------------------------------


@tracing.spanned("step_loop")
def _scan_cohorts(cohorts: Sequence[Tuple[FrozenGraph, Sequence[int],
                                          Sequence[Layout],
                                          Optional[np.ndarray]]],
                  policy: str, *, chunk: int, device: torch.device,
                  cache: Optional[CompileCache],
                  slot_bucketed: bool = False
                  ) -> List[Tuple[Dict[int, SimResult], List[int],
                                  Dict[int, float]]]:
    """Drive every lane of every ``(fg, order, layouts, cutoffs)`` cohort
    through the shared step loop on ``device``: each slice through the
    ``cache``'s runner of its signature (:class:`StepRunner`), or, with
    ``cache=None``, through :func:`_steps` run eagerly on the slice.  A
    cohort whose ``order`` is None steps each lane through its own heap
    order (:func:`_own_xs`); replayed and own-order cohorts share slices.
    The step inputs of every cohort are staged once a call, and only when
    the device cache lacks them (a repeat sweep's cohorts hit it):
    own-order tables inside ``step.tables`` spans, the stack, packing and
    copy to the device inside ``step.stage``.

    Task-axis padding layout: per-cohort step inputs (:func:`_group_xs`)
    are stacked into ``[T_pad, G, ...]`` blocks, ``T_pad`` the longest
    cohort rounded up to a multiple of :data:`STEPS` (so that a runner's
    signature does not depend on it) — steps beyond a cohort's own length
    carry ``valid=False``, the dummy row id ``n_max`` and
    all-dummy successor lists, so they update nothing; rows/pools/options
    pad to the megabatch maxima with inert values (``-1`` options, dummy
    successors, ``inf`` clocks beyond a lane's slot count).  Lanes from
    *all* cohorts share the bucketed lane axis (``chunk`` caps the bucket;
    padding lanes replicate the last real lane).

    ``slot_bucketed=True`` (the megabatch path) sorts lanes by the slot
    count they actually need and runs each slice with the narrowest
    power-of-two slot axis covering it; lanes pack greedily up to
    ``chunk``, and a new slice only opens at a slot-bucket boundary once
    the current one is full (see :func:`_width`).  The per-graph path keeps
    one global slot axis.

    Retirement is **post-scan classification**: a cohort with a finite
    ``cutoffs`` entry has its non-diverged lanes whose *final* makespan
    exceeds the cutoff reported as retired (the makespan itself is the
    bound — exact, not an estimate).

    Returns one ``(done, diverged, retired)`` triple per cohort in the
    :data:`repro_torch.core.replay.LockstepFn` contract."""
    eft = policy == "eft"
    # cohorts in an order of their content, so that a repeat sweep's
    # device blocks hit the cache whatever order its families came in
    canon = sorted(range(len(cohorts)), key=lambda ci: (
        cohorts[ci][0].content_hash(), cohorts[ci][1] is not None,
        tuple(cohorts[ci][1] or ()), tuple(cohorts[ci][2][0][2])))
    cohorts = [cohorts[ci] for ci in canon]

    per = []
    with tracing.span("step.stage"):
        for fg, order, layouts, cuts in cohorts:
            pool_names, _, kind_pool = layouts[0]       # template-shared
            kinds = fg.kinds
            own = order is None
            caps = _pool_caps(fg, kind_pool, len(pool_names))
            lane_counts = [lay[1] for lay in layouts]
            per.append({
                "fg": fg, "order": order, "own": own,
                "pos_of": _heap_order(fg)[2] if own else None, "cuts": cuts,
                "pool_names": pool_names, "kind_pool": list(kind_pool),
                "smp_kid": kinds.index("smp") if "smp" in kinds else -1,
                "lane_counts": lane_counts,
                # slot-axis need per lane: pool slot counts clamped to
                # the dispatch caps (exact — see _pool_caps)
                "needs": [max(1, max((min(int(c), int(caps[p]))
                                      for p, c in enumerate(cnt)),
                                     default=1))
                          for cnt in lane_counts],
                "n": fg.n, "P": len(pool_names),
            })
    G = len(per)
    n_max = max(c["n"] for c in per)
    P_max = max(c["P"] for c in per)
    T_pad = -(-n_max // STEPS) * STEPS      # every cohort steps all its rows
    K = max(_width_of(c["fg"].dev_indptr) for c in per)
    NK = max(len(c["kind_pool"]) for c in per)
    SC = max(_width_of(c["fg"].succ_indptr) for c in per)
    S = _bucket(max(nd for c in per for nd in c["needs"]), cap=1 << 30)

    kind_pool_m = np.full((G, NK), -1, dtype=np.int64)
    smp_kid_m = np.full((G,), -1, dtype=np.int64)
    own_m = np.array([c["own"] for c in per], dtype=bool)
    for gi, c in enumerate(per):
        nk = len(c["kind_pool"])
        kind_pool_m[gi, :nk] = c["kind_pool"]
        smp_kid_m[gi] = c["smp_kid"]

    def _mega(xss: List[Dict[str, np.ndarray]],
              npreds: List[Optional[np.ndarray]]) -> Dict[str, np.ndarray]:
        """The cohorts' step inputs ``xss`` stacked ``[T_pad, G, ...]``,
        padded along the task axis."""
        mega = {
            "valid": np.zeros((T_pad, G), dtype=bool),
            "r": np.full((T_pad, G), n_max, dtype=np.int64),
            "tb": np.zeros((T_pad, G), dtype=np.int64),
            "c": np.full((T_pad, G), -1, dtype=np.int64),
            "is_comp": np.zeros((T_pad, G), dtype=bool),
            "k_first": np.zeros((T_pad, G), dtype=np.int64),
            "own_opts": np.full((T_pad, G, K), -1, dtype=np.int64),
            "own_cost": np.zeros((T_pad, G, NK), dtype=np.float64),
            "par_opts": np.full((T_pad, G, K), -1, dtype=np.int64),
            "par_cost": np.zeros((T_pad, G, NK), dtype=np.float64),
            "act": np.zeros((T_pad, G, NK), dtype=bool),
            "bad_row": np.zeros((T_pad, G), dtype=bool),
            "succ": np.full((T_pad, SC, G), n_max, dtype=np.int64),
            "npred": np.ones((n_max + 1, G), dtype=np.int32),
        }
        for gi, (c, xs, npred) in enumerate(zip(per, xss, npreds)):
            T, n = len(xs["r"]), c["n"]
            kg, nk, sc = (xs["own_opts"].shape[1], xs["own_cost"].shape[1],
                          xs["succ"].shape[1])
            mega["valid"][:T, gi] = True
            for f in ("r", "tb", "c", "is_comp", "k_first", "bad_row"):
                mega[f][:T, gi] = xs[f]
            mega["own_opts"][:T, gi, :kg] = xs["own_opts"]
            mega["par_opts"][:T, gi, :kg] = xs["par_opts"]
            mega["own_cost"][:T, gi, :nk] = xs["own_cost"]
            mega["par_cost"][:T, gi, :nk] = xs["par_cost"]
            mega["act"][:T, gi, :nk] = xs["act"]
            # each cohort's own dummy successor row is its fg.n — remap to
            # the megabatch-wide dummy ready row n_max.  Successors are
            # stored [T, SC, G] so each step's index block is the [SC, B]
            # shape scatter_reduce_ takes along the task axis.
            mega["succ"][:T, :sc, gi] = np.where(xs["succ"] == n, n_max,
                                                 xs["succ"])
            if npred is not None:
                mega["npred"][:n, gi] = npred
        return mega

    # cache key of the device blocks: content-based, so repeat sweeps hit
    # it across fresh Explorers
    base_key = (str(device),
                tuple((c["fg"].content_hash(),
                       None if c["own"] else tuple(c["order"]),
                       tuple(c["kind_pool"])) for c in per),
                (T_pad, n_max, P_max, K, NK, SC),
                kind_pool_m.tobytes(), smp_kid_m.tobytes())

    lanes_flat = [(gi, pos) for gi, c in enumerate(per)
                  for pos in range(len(c["lane_counts"]))]
    accs = [{"kept": [], "mk": [], "busy": [], "seen": [], "place": []}
            for _ in per]
    diverged: List[List[int]] = [[] for _ in per]
    retired: List[Dict[int, float]] = [{} for _ in per]
    step = _bucket(chunk, cap=chunk)    # effective power-of-two slice width

    def _need(lane):
        gi, pos = lane
        return per[gi]["needs"][pos]

    def _width(S_sl: int) -> int:
        """Lane width keeping the slice's clock block near the target:
        ``P_max × S_sl × width ≈ TARGET_SLICE_ELEMS``, floored at 16 lanes
        and capped by ``chunk``.  On the card a slice costs its steps'
        launch latency whatever its width, so it fills to ``chunk``."""
        if device.type == "cuda":
            return step
        return max(16, min(step,
                           _bucket(TARGET_SLICE_ELEMS // (P_max * S_sl),
                                   cap=1 << 30)))

    slices: List[Tuple[List[Tuple[int, int]], int]] = []
    if slot_bucketed:
        by_slots = sorted(lanes_flat, key=lambda t: (_need(t), t))
        cur: List[Tuple[int, int]] = []
        cur_S = 1
        for lane in by_slots:
            nb = max(cur_S, _bucket(_need(lane), cap=1 << 30))
            if cur and len(cur) >= _width(nb):
                slices.append((cur, cur_S))
                cur, cur_S = [], 1
                nb = _bucket(_need(lane), cap=1 << 30)
            cur.append(lane)
            cur_S = nb
        if cur:
            slices.append((cur, cur_S))
    else:
        slices = [(lanes_flat[lo:lo + step], S)
                  for lo in range(0, len(lanes_flat), step)]

    def _blocks() -> Tuple:
        """Every cohort's step inputs packed (:func:`_pack`) on ``device``,
        cohort-last, with each cohort's pool map, SMP kind, ``npred`` and
        own-order flag (:class:`_State`), memoised by content."""
        with _CACHE_LOCK:
            hit = _DEV_XS_CACHE.get(base_key)
            if hit is not None:
                _DEV_XS_CACHE.move_to_end(base_key)
                return hit
        xss, npreds = [], []
        for c in per:
            if c["own"]:
                with tracing.span("step.tables"):
                    xs, _, npred = _own_xs(c["fg"], c["kind_pool"])
            else:
                xs, npred = _group_xs(c["fg"], c["order"],
                                      c["kind_pool"]), None
            xss.append(xs)
            npreds.append(npred)
        with tracing.span("step.stage"):
            mega = _mega(xss, npreds)
            hit = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (*_pack(mega), kind_pool_m, smp_kid_m,
                                  mega["npred"], own_m))
        with _CACHE_LOCK:
            if base_key not in _DEV_XS_CACHE \
                    and len(_DEV_XS_CACHE) >= _DEV_XS_CACHE_CAP:
                _DEV_XS_CACHE.popitem(last=False)
            _DEV_XS_CACHE[base_key] = hit
        return hit

    try:
        xi_c, xf_c, xb_c, kp_c, sk_c, np_c, own_c = _blocks()
    except _CARD_ERRORS as exc:
        raise DeviceError(f"the device failed staging the torch step loop "
                          f"on {device}: {exc}") from exc
    for sl, S_sl in slices:
        B = _bucket(len(sl), cap=chunk)
        try:
            with tracing.span("step.stage"):
                # pad lanes replicate the last real lane: finite, well-
                # defined state whose results are dropped before assembly
                padded = sl + [sl[-1]] * (B - len(sl))
                g_np = np.fromiter((gi for gi, _ in padded), dtype=np.int64,
                                   count=B)
                clocks = np.full((P_max, S_sl, B), np.inf)
                for li, (gi, pos) in enumerate(padded):
                    for p, cnt in enumerate(per[gi]["lane_counts"][pos]):
                        clocks[p, :cnt, li] = 0.0
                # the slice's cohorts' columns, and each lane's own
                # constants and column among them
                cols, col_of = np.unique(g_np, return_inverse=True)
                cols_d, g_d, col_d = (torch.from_numpy(a).to(device)
                                      for a in (cols, g_np, col_of))
                xi_d, xf_d, xb_d = (b.index_select(2, cols_d)
                                    for b in (xi_c, xf_c, xb_c))
                kp_d, sk_d, own_d = (b.index_select(0, g_d)
                                     for b in (kp_c, sk_c, own_c))
                np_d = np_c.index_select(1, g_d)
                runner = None if cache is None else _load_runner(
                    cache, (P_max, S_sl, B, n_max + 1, xi_d.shape[1], NK, K),
                    device, eft)
            with tracing.span("step.run"):
                if runner is None:
                    st = _State(P_max, S_sl, B, n_max + 1, device)
                    st.reset(clocks, np_d, own_d, col_d)
                    _steps(xi_d, xf_d, xb_d, st, kp_d, sk_d, eft, K)
                    out = st.outputs()
                else:
                    out = runner.run(xi_d, xf_d, xb_d, clocks, kp_d, sk_d,
                                     np_d, own_d, col_d)
            div_np, mk_np, busy_np, seen_np, place_np = out
        except _CARD_ERRORS as exc:
            raise DeviceError(f"the device failed in the torch step loop "
                              f"on {device}: {exc}") from exc
        with tracing.span("step.classify"):
            for li, (gi, pos) in enumerate(sl):
                if div_np[li]:
                    diverged[gi].append(pos)
                    continue
                acc, c = accs[gi], per[gi]
                cuts = c["cuts"]
                if cuts is not None and mk_np[li] > cuts[pos]:
                    # post-scan retirement: the final makespan is its own
                    # (exact) bound, and it exceeds the incumbent cutoff
                    retired[gi][pos] = float(mk_np[li])
                    continue
                acc["kept"].append(pos)
                acc["mk"].append(mk_np[li:li + 1])
                acc["busy"].append(busy_np[:c["P"], li:li + 1])
                acc["seen"].append(seen_np[:c["P"], li:li + 1])
                # an own-order lane's rows are in heap order: back to
                # the graph's
                acc["place"].append(place_np[c["pos_of"], li:li + 1]
                                    if c["own"]
                                    else place_np[:c["n"], li:li + 1])

    results: List[Tuple[Dict[int, SimResult], List[int],
                        Dict[int, float]]] = []
    with tracing.span("step.classify"):
        for gi, c in enumerate(per):
            acc = accs[gi]
            done: Dict[int, SimResult] = {}
            if acc["kept"]:
                done = lane_results(
                    c["fg"], c["pool_names"], c["lane_counts"], acc["kept"],
                    policy, np.concatenate(acc["mk"]),
                    np.concatenate(acc["busy"], axis=1),
                    np.concatenate(acc["seen"], axis=1),
                    np.concatenate(acc["place"], axis=1).astype(np.int64))
            results.append((done, diverged[gi], retired[gi]))
    return [results[pos] for pos in np.argsort(canon)]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _cache_for(compile_cache: Optional[CompileCache],
               graphs: bool) -> Optional[CompileCache]:
    """The cache a sweep's slices go through: None (eager) when
    ``graphs`` is off, else ``compile_cache`` or the process-wide one."""
    if not graphs:
        return None
    return _DEFAULT_CACHE if compile_cache is None else compile_cache


def simulate_torch(fg: FrozenGraph, systems: Sequence[SystemConfig],
                   policy: str = "availability", *,
                   device: DeviceLike = None,
                   min_lockstep: int = MIN_LOCKSTEP,
                   chunk: int = DEFAULT_CHUNK,
                   stats: Optional[BatchStats] = None,
                   library: Optional[ReplayLibrary] = None,
                   max_rounds: int = MAX_RESCUE_ROUNDS,
                   rescue_min: int = RESCUE_MIN,
                   prune: Optional[PruneContext] = None,
                   compile_cache: Optional[CompileCache] = None,
                   graphs: bool = True):
    """Schedule-free :class:`SimResult` per system, in input order.

    The torch tier of :func:`repro_torch.core.batchsim.simulate_batch`:
    equivalent to ``[simulate_fast(fg, s, policy) for s in systems]`` at
    :data:`~repro_torch.core.replay.TORCH_RTOL` relative makespan/busy
    error with identical placements, and ranking-stable under the
    documented tie-break.  Grouping, multi-order library replay and the
    per-lane fallback are the shared :mod:`repro_torch.core.replay`
    protocol, with this engine's own-order seam: a lane no shared order
    serves steps its own heap order on the device instead of running the
    exact path (but a group's first discovery; not under ``prune``).
    ``chunk`` caps the lane-bucket width (non-power-of-two caps round
    down).  ``device`` defaults to the card.

    ``prune`` enables lane retirement
    (:class:`~repro_torch.core.replay.PruneContext`): lanes whose makespan
    exceeds the incumbent cutoff, pre-inflated by the engine's tolerance,
    come back as :class:`~repro_torch.core.replay.Retired` markers.

    The step loop runs through runners of the compile cache
    (:class:`~repro_torch.core.graphcache.CompileCache`): ``compile_cache``
    names one (like ``simulate_jax``'s), else the process-wide in-memory
    cache serves.  On the card a runner replays a captured CUDA graph.
    ``graphs=False`` runs the loop eagerly instead, bypassing the cache
    (an A/B check's other side)."""
    dev = resolve_device(device)
    require_torch()
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk!r}")
    cache = _cache_for(compile_cache, graphs)

    def lockstep(fg, order, layouts, policy, cutoffs=None):
        (triple,) = _scan_cohorts([(fg, order, layouts, cutoffs)], policy,
                                  chunk=chunk, device=dev, cache=cache)
        return triple

    return simulate_grouped(fg, systems, policy, min_lockstep=min_lockstep,
                            stats=stats, library=library,
                            max_rounds=max_rounds, rescue_min=rescue_min,
                            lockstep_fn=lockstep, prune=prune,
                            own_order_fn=lockstep)


def simulate_torch_many(items: Sequence[Tuple[FrozenGraph,
                                              Sequence[SystemConfig]]],
                        policy: str = "availability", *,
                        device: DeviceLike = None,
                        min_lockstep: int = MIN_LOCKSTEP,
                        chunk: Optional[int] = None,
                        stats: Optional[BatchStats] = None,
                        library: Optional[ReplayLibrary] = None,
                        max_rounds: int = MAX_RESCUE_ROUNDS,
                        prunes: Optional[Sequence[Optional[PruneContext]]]
                        = None,
                        compile_cache: Optional[CompileCache] = None,
                        graphs: bool = True) -> List[List[SimResult]]:
    """Multi-graph megabatch: every ``(graph, systems)`` family of a sweep
    through one shared lane axis.

    Per family the results match ``simulate_torch(fg, systems, ...)`` at
    the same tier — routing, discovery and the own-order lanes are
    :func:`repro_torch.core.replay.simulate_many` with this engine's
    own-order seam — but heterogeneous graphs share the lane axis
    (task-axis padding, cohort-last step inputs each lane gathers from,
    slot-bucketed slices), replayed and own-order cohorts alike.
    ``chunk`` defaults to :data:`MEGABATCH_CHUNK`; ``compile_cache`` and
    ``graphs`` as :func:`simulate_torch`'s."""
    dev = resolve_device(device)
    require_torch()
    chunk = MEGABATCH_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk!r}")
    cache = _cache_for(compile_cache, graphs)

    def lockstep_many(cohorts):
        return _scan_cohorts(cohorts, policy, chunk=chunk, device=dev,
                             cache=cache, slot_bucketed=True)

    return simulate_many(items, policy, lockstep_many_fn=lockstep_many,
                         min_lockstep=min_lockstep, stats=stats,
                         library=library, max_rounds=max_rounds,
                         prunes=prunes, own_order_fn=lockstep_many)
