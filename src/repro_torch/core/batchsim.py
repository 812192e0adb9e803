"""Candidate-axis batched simulation engine — one graph, all candidates.

:func:`repro_torch.core.fastsim.simulate_fast` made the *per-candidate* event
loop cheap; a co-design sweep still pays that loop once per candidate even
though (on the fig6 grid) 198/200 candidates share a single
:class:`~repro_torch.core.fastsim.FrozenGraph` and differ only in pool slot
counts.  This module evaluates **every candidate sharing one frozen graph
in a single lockstep sweep**: per-candidate state is stacked on a
candidate ("lane") axis — pool free-slot times ``[n_pools, max_slots,
B]``, task ready times ``[n, B]``, placement ids ``[n, B]``.  The **lane
-last axis convention** is an invariant shared with the torch backend: the
lane axis sits last in every stacked array, so each step touches
contiguous vectors and the backends' state layouts (and the shared
assembly helper) stay interchangeable — and each step advances
*all* lanes through one task row with numpy (an argmin over the slot axis
replaces ``_Pool.earliest_slot``, per-kind cost gathers replace the
dispatch probe).

**Why this is exact.**  The reference engine pops tasks in ``(ready_t,
creation_index, uid)`` heap order, and pool contention makes results
order-sensitive — different slot counts *can* pop in different orders.  The
batch engine therefore replays one **reference order** (recorded by running
the highest-parallelism lane through the bit-identical ``simulate_fast``
path) and validates every other lane against two facts:

* the *set* of ready tasks at each step depends only on the graph and on
  which rows already executed — identical across lanes by construction;
* a lane's execution order equals its own heap order **iff** its popped
  keys are strictly increasing along the replayed order (heap pops are
  monotone, keys are distinct, so any deviation must eventually pop a
  smaller key than its predecessor).

Each step checks that one lexicographic key comparison per lane.  Lanes
that pass to the end are bit-identical to their own ``simulate_fast`` run
— same floats, same placements, same busy sums (pinned by randomized
tests under both policies).  A lane that fails is *masked out of the
batch* and re-simulated serially through ``simulate_fast`` — the check can
fire later than the first deviation, so the lane's lockstep state is
discarded rather than resumed; correctness never depends on how late the
divergence is caught.  Conditional-DMA divergence (a compute task landing
on the SMP in some lanes only) stays inside the lockstep: the skip is a
per-lane mask, not an order change.

Everything here is schedule-free by construction (``SimResult.schedule``
is empty); full :class:`~repro_torch.core.simulator.ScheduledTask` records for
top-k winners are replayed through ``simulate_fast(with_schedule=True)``
by the exploration engine, exactly as before.

The grouping / reference-order / fallback protocol around the sweep is
shared with the torch backend (:mod:`repro_torch.core.torchsim`) and lives in
:mod:`repro_torch.core.replay`; this module supplies only the numpy inner loop
(:func:`_run_lockstep`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .devices import SystemConfig
from .fastsim import FrozenGraph, simulate_fast  # noqa: F401 — re-export
from .replay import (BatchStats, MAX_RESCUE_ROUNDS, MIN_LOCKSTEP,
                     PruneContext, RESCUE_MIN, ReplayLibrary, bound_aux,
                     graph_aux, lane_results, simulate_grouped)
from .simulator import SimResult
from ..testing import faults

# Steps between heap-key validations / makespan folds: big enough to
# amortise the stacked checks, small enough to bound a diverged lane's
# wasted lockstep work.
_WINDOW = 24

# Retired lanes are compacted out of the stacked state once at least this
# fraction of the current lanes is dead (retired but still carried) — one
# repack amortises over many retirements; below the threshold dead lanes
# ride along in the vector ops, which cost the same either way.
RETIRE_COMPACT_FRAC = 0.25


def simulate_batch(fg: FrozenGraph, systems: Sequence[SystemConfig],
                   policy: str = "availability", *,
                   min_lockstep: int = MIN_LOCKSTEP,
                   stats: Optional[BatchStats] = None,
                   library: Optional[ReplayLibrary] = None,
                   max_rounds: int = MAX_RESCUE_ROUNDS,
                   rescue_min: int = RESCUE_MIN,
                   prune: Optional[PruneContext] = None) -> List[SimResult]:
    """Schedule-free :class:`SimResult` per system, in input order.

    Ranking-identical to ``[simulate_fast(fg, s, policy) for s in
    systems]`` — same makespans, placements and busy sums float-for-float
    — at a fraction of the per-candidate cost when candidates share the
    graph.  Systems are grouped by *pool template* (pool names/kinds and
    the kind→pool map — slot counts are free to vary inside a group); each
    group replays dispatch orders from ``library`` (an ephemeral one when
    ``None``) with lockstep rescue of diverged cohorts, bounded by
    ``max_rounds`` serial discoveries — see
    :func:`repro_torch.core.replay.replay_group`.  A shared library makes repeat
    sweeps start warm: every lane routes straight to the order its slot
    counts validated against before.

    With a :class:`~repro_torch.core.replay.PruneContext` (``prune``), lanes
    whose monotone partial bound exceeds the incumbent cutoff are retired
    mid-sweep and returned as :class:`~repro_torch.core.replay.Retired` markers
    in their result slots; without one every slot is a SimResult.
    """
    return simulate_grouped(fg, systems, policy, min_lockstep=min_lockstep,
                            stats=stats, library=library,
                            max_rounds=max_rounds, rescue_min=rescue_min,
                            prune=prune, lockstep_fn=_run_lockstep)


def _run_lockstep(fg: FrozenGraph, order: Sequence[int],
                  layouts: Sequence[Tuple[List[str], List[int], List[int]]],
                  policy: str, cutoffs: Optional[np.ndarray] = None
                  ) -> Tuple[Dict[int, SimResult], List[int],
                             Dict[int, float]]:
    """Drive every lane through ``order``; return ``(done, diverged,
    retired)``.

    ``done`` maps lane position -> schedule-free SimResult (``system`` is
    filled by the caller); ``diverged`` lists lane positions whose heap
    keys broke monotonicity somewhere — their state is abandoned;
    ``retired`` maps lane position -> the monotone partial bound that
    exceeded the lane's ``cutoffs`` entry mid-sweep.

    Validation and makespan folding are *windowed*: popped ready times and
    task end times are buffered per step and checked/folded every
    ``_WINDOW`` steps in a couple of stacked array ops instead of two per
    step.  Late detection is already part of the exactness contract (a
    diverged lane's state is discarded, never resumed), so letting a bad
    lane run to the end of its window costs only its own wasted work.

    **Retirement exactness.**  The running bound folds ``end_eff + tsm``
    per step (:func:`~repro_torch.core.replay.bound_aux`), which lower-bounds a
    lane's final makespan *only if the replayed prefix equals the lane's
    true simulation prefix* — and monotonicity alone cannot certify that
    at a window boundary, because a deviation can be detected late.  The
    flush therefore also checks the *static ready set* ``R_t`` (rows with
    every predecessor executed in the order prefix, not yet popped —
    identical across lanes, maintained incrementally): if the popped keys
    were monotone through step ``t`` **and** every row still in ``R_t``
    has a strictly larger ``(ready, tie_break)`` key than the one popped
    at ``t``, any earlier deviation would have been caught — a deviating
    row either got popped by ``t`` (key inversion → the monotone check)
    or is still in ``R_t`` with a smaller key (→ this check).  Only lanes
    certified exact this way are retired; ties make the check
    conservatively refuse, which costs performance, never correctness.
    Retired lanes stop being validated or reported but their columns ride
    along until at least ``RETIRE_COMPACT_FRAC`` of the lanes are dead,
    then one repack compacts the candidate axis in place.
    """
    if faults.fire("fail_lockstep"):
        raise RuntimeError("injected fault: fail_lockstep")
    eft = policy == "eft"
    kinds = fg.kinds
    smp_kid = kinds.index("smp") if "smp" in kinds else -1
    (uids, ci, cond, dev_first, dev_opts, asets, costs, succs,
     _n_pred, is_comp, rankmaps, _heap0, comp_rows) = fg._runtime()
    n = fg.n
    tb, act_mask = graph_aux(fg, ci, rankmaps[0], asets)
    cost_np = fg.cost                      # float64[n, n_kinds], NaN = absent

    pool_names, _, kind_pool = layouts[0]   # template-shared
    kind_pool_np = np.asarray(kind_pool, dtype=np.int64)
    P = len(pool_names)
    lane_counts = [lay[1] for lay in layouts]
    # per-pool real slot width (beyond it every lane is inf-padded) — lets
    # the hot single-pool dispatches scan [L, cap] instead of [L, max_slots]
    pool_cap = [max(c[p] for c in lane_counts) for p in range(P)]
    S = max(pool_cap)

    # lane axis LAST everywhere: the per-step accesses (one task row, one
    # pool) then touch contiguous [L] vectors instead of strided columns
    L = len(layouts)
    clocks = np.full((P, S, L), np.inf)
    for li, counts in enumerate(lane_counts):
        for p, cnt in enumerate(counts):
            clocks[p, :cnt, li] = 0.0
    ready = np.zeros((n, L))
    placement = np.full((n, L), -1, dtype=np.int64)
    busy = np.zeros((P, L))
    seen = np.zeros((P, L), dtype=bool)
    makespan = np.zeros(L)
    alive = np.arange(L)                   # original lane positions
    aL = np.arange(L)
    diverged: List[int] = []
    # pools committed by a full-width dispatch: every surviving lane ran the
    # commit, so the per-lane `seen` write is hoisted out of the hot loop
    seen_pools: set = set()
    # conditional rows of one unit share (parent, active set) — and the
    # parent's placement is fixed once decided — so their skip mask is
    # computed once and reused (invalidated on lane compression)
    cond_mask_cache: Dict[Tuple[int, frozenset], Optional[np.ndarray]] = {}
    # windowed validation / makespan buffers (see docstring)
    win_rts: List[np.ndarray] = [np.full(L, -np.inf)]
    win_tb: List[int] = [-1]
    end_buf: List[np.ndarray] = []

    # ---- retirement state (prune mode only) -------------------------------
    prune_on = cutoffs is not None
    retired: Dict[int, float] = {}
    if prune_on:
        _tail, tsm_arr = bound_aux(fg)
        tsm_l = tsm_arr.tolist()
        tb_np = np.asarray(tb, dtype=np.int64)
        cut = np.asarray(cutoffs, dtype=float).copy()
        bnd = np.zeros(L)                   # running monotone partial bound
        deadm = np.zeros(L, dtype=bool)     # retired, not yet compacted
        win_tsm: List[float] = []
        # static ready set R_t: rows whose preds all executed in the order
        # prefix and that were not themselves popped — lane-independent
        rem = list(_n_pred)
        rset = {i for i in range(n) if rem[i] == 0}

    def choose(row: int, rt: np.ndarray) -> np.ndarray:
        """Vectorised `_choose_kind` over all current lanes: same option
        order, same strict-< tie-breaks as the reference — one kind id per
        lane.  Pure (no state writes), so computing it for lanes that end
        up skipping the row is harmless."""
        best_k = np.full(rt.shape, -1, dtype=np.int64)
        bv = np.zeros(rt.shape)
        bp = np.zeros(rt.shape, dtype=np.int64)
        for k in dev_opts[row]:
            pi = kind_pool[k]
            if pi < 0:
                continue
            base = costs[row][k]
            if base != base:                # NaN — cost_on would KeyError
                raise KeyError(
                    f"task {fg.names[row]}#{uids[row]} has no cost for "
                    f"device kind {kinds[k]!r}")
            t = clocks[pi, :pool_cap[pi]].min(axis=0)
            start = np.maximum(rt, t)
            keyv = start + base if eft else start
            pref = 1 if k == smp_kid else 0
            better = (best_k < 0) | (keyv < bv) | ((keyv == bv) & (pref < bp))
            bv = np.where(better, keyv, bv)
            bp = np.where(better, pref, bp)
            best_k = np.where(better, k, best_k)
        if (best_k < 0).any():
            raise RuntimeError(
                f"task {fg.names[row]}#{uids[row]}: no compatible pool among "
                f"kinds {tuple(kinds[k] for k in dev_opts[row])}")
        return best_k

    def flush_window() -> bool:
        """Validate the buffered window's heap-key monotonicity, fold the
        buffered end times into makespans (and, in prune mode, into the
        running partial bounds — retiring provably-beaten lanes), compress
        out diverged lanes (and retired ones past the compaction
        threshold).  Returns False when every lane is dead."""
        nonlocal ready, placement, clocks, busy, seen, makespan, alive, \
            aL, L, win_rts, win_tb, end_buf, win_tsm, bnd, cut, deadm
        rts = np.stack(win_rts)                       # [W+1, L]
        viol = rts[1:] < rts[:-1]
        # ties on ready time are only legal when the static tie-break
        # ascends (distinct rows -> tb never repeats)
        strict = np.fromiter(
            (win_tb[i + 1] <= win_tb[i] for i in range(len(win_tb) - 1)),
            dtype=bool, count=len(win_tb) - 1)
        if strict.any():
            viol |= (rts[1:] == rts[:-1]) & strict[:, None]
        bad = viol.any(axis=0)
        np.maximum(makespan, np.stack(end_buf).max(axis=0), out=makespan)
        last_rt = win_rts[-1]
        keep: Optional[np.ndarray] = None
        if prune_on:
            bad &= ~deadm       # retired lanes left validation already
            np.maximum(
                bnd, (np.stack(end_buf)
                      + np.asarray(win_tsm)[:, None]).max(axis=0),
                out=bnd)
            cand = ~bad & ~deadm & (bnd > cut)
            if cand.any():
                # prefix-exactness certificate (see docstring): monotone
                # so far AND every still-ready row's key strictly above
                # the last popped key — retiring is only legal for lanes
                # whose replayed prefix is provably their true prefix
                if rset:
                    ys = np.fromiter(rset, dtype=np.int64,
                                     count=len(rset))
                    ra = ready[ys]                          # [m, L]
                    tbv = tb_np[ys]
                    exact = ((ra > last_rt[None, :])
                             | ((ra == last_rt[None, :])
                                & (tbv[:, None] > win_tb[-1]))).all(axis=0)
                    cand &= exact
                for li in np.flatnonzero(cand):
                    retired[int(alive[li])] = float(bnd[li])
                deadm |= cand
            if bad.any() or deadm.all() \
                    or deadm.sum() >= max(1.0, RETIRE_COMPACT_FRAC * L):
                keep = ~(bad | deadm)
        elif bad.any():
            keep = ~bad
        if keep is not None:
            diverged.extend(alive[bad].tolist())
            ready = ready[:, keep]
            placement = placement[:, keep]
            clocks = clocks[:, :, keep]
            busy = busy[:, keep]
            seen = seen[:, keep]
            makespan = makespan[keep]
            alive = alive[keep]
            last_rt = last_rt[keep]
            if prune_on:
                bnd = bnd[keep]
                cut = cut[keep]
                deadm = np.zeros(alive.size, dtype=bool)
            L = alive.size
            if L == 0:
                return False
            aL = np.arange(L)
            cond_mask_cache.clear()
        win_rts = [last_rt]
        win_tb = [win_tb[-1]]
        end_buf = []
        if prune_on:
            win_tsm = []
        return True

    _MISS = object()
    for r in order:
        rt = ready[r]                       # contiguous view, never mutated
        win_rts.append(rt)
        win_tb.append(tb[r])

        # ---- conditional pass-through (per-lane mask, not order change) --
        c = cond[r]
        live_mask: Optional[np.ndarray] = None       # None == all lanes run
        if c >= 0:
            ck = (c, asets[r])
            cached = cond_mask_cache.get(ck, _MISS)
            if cached is not _MISS:
                live_mask = cached
            else:
                pk = placement[c]
                und = pk < 0
                if und.any():
                    # first unit member to wake decides compute placement
                    pk = np.where(und, choose(c, rt), pk)
                    placement[c] = pk
                live_mask = act_mask[r][pk]
                if live_mask.all():
                    live_mask = None
                cond_mask_cache[ck] = live_mask

        # ---- dispatch + commit for the lanes that execute the row --------
        if live_mask is None or live_mask.any():
            if is_comp[r]:
                k = placement[r]            # view; replaced if undecided
                und = k < 0
                if und.any():
                    k = np.where(und, choose(r, rt), k)
                    if live_mask is None:
                        placement[r] = k
                    else:           # skipping lanes never place this row
                        placement[r][live_mask] = k[live_mask]
                p = kind_pool_np[k]
                bad = (p < 0) if live_mask is None else ((p < 0) & live_mask)
                if bad.any():
                    raise KeyError(kinds[int(k[np.argmax(bad)])])
                base = cost_np[r][k]
                bad = np.isnan(base)
                if live_mask is not None:
                    bad &= live_mask
                if bad.any():
                    raise KeyError(
                        f"task {fg.names[r]}#{uids[r]} has no cost for device "
                        f"kind {kinds[int(k[np.argmax(bad)])]!r}")
                scalar_pool = False
            else:
                k0 = dev_first[r]
                p0 = kind_pool[k0]
                if p0 < 0:
                    raise KeyError(kinds[k0])
                base = costs[r][k0]
                if base != base:
                    raise KeyError(
                        f"task {fg.names[r]}#{uids[r]} has no cost for "
                        f"device kind {kinds[k0]!r}")
                scalar_pool = True
            if live_mask is None:
                if scalar_pool:
                    seen_pools.add(p0)
                    if pool_cap[p0] == 1:
                        # submit/dma_out-style serialising resources: the
                        # single slot IS the argmin
                        cl = clocks[p0, 0]
                        start = np.maximum(rt, cl)
                        end = start + base
                        clocks[p0, 0] = end
                    else:
                        cl = clocks[p0, :pool_cap[p0]]  # [cap, L] view
                        s = cl.argmin(axis=0)
                        tmin = cl[s, aL]
                        start = np.maximum(rt, tmin)
                        end = start + base
                        cl[s, aL] = end
                    busy[p0] += end - start
                else:
                    cl = clocks[p, :, aL]              # [L, S] gather
                    s = cl.argmin(axis=1)
                    tmin = cl[aL, s]
                    start = np.maximum(rt, tmin)
                    end = start + base
                    clocks[p, s, aL] = end
                    busy[p, aL] += end - start
                    seen[p, aL] = True
                end_eff = end
            else:
                live = aL[live_mask]
                pl = np.full(live.size, p0, dtype=np.int64) if scalar_pool \
                    else p[live]
                cl = clocks[pl, :, live]               # [m, S] gather
                s = cl.argmin(axis=1)
                m = np.arange(live.size)
                tmin = cl[m, s]
                start = np.maximum(rt[live], tmin)
                end = start + (base if scalar_pool else base[live])
                clocks[pl, s, live] = end
                busy[pl, live] += end - start
                seen[pl, live] = True
                end_eff = rt.copy()
                end_eff[live] = end
        else:
            end_eff = rt                   # every lane skipped this row
        end_buf.append(end_eff)
        if prune_on:
            win_tsm.append(tsm_l[r])
            rset.discard(r)
            for j in succs[r]:
                np.maximum(ready[j], end_eff, out=ready[j])
                rem[j] -= 1
                if rem[j] == 0:
                    rset.add(j)
        else:
            for j in succs[r]:
                np.maximum(ready[j], end_eff, out=ready[j])
        if len(end_buf) >= _WINDOW and not flush_window():
            return {}, diverged, retired
    if end_buf and not flush_window():
        return {}, diverged, retired

    # ---- assemble per-lane schedule-free results --------------------------
    for p in seen_pools:
        seen[p] = True
    if prune_on and deadm.any():
        # retired lanes still riding below the compaction threshold: drop
        # them now so they are never assembled into results
        fin = ~deadm
        alive, makespan = alive[fin], makespan[fin]
        busy, seen = busy[:, fin], seen[:, fin]
        placement = placement[:, fin]
    done = lane_results(fg, pool_names, lane_counts, alive.tolist(), policy,
                        makespan, busy, seen, placement)
    return done, diverged, retired
