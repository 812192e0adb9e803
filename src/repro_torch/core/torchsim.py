"""Torch candidate-axis engine: the lockstep sweep as a step loop on a device.

:mod:`repro_torch.core.batchsim` proved the lockstep formulation: every
candidate sharing one :class:`~repro_torch.core.fastsim.FrozenGraph`
advances through one replayed reference event order with per-candidate
state stacked on a candidate ("lane") axis.  This module runs the same
per-step semantics as a Python loop over the replayed order whose body is
a fixed sequence of tensor operations on the chosen ``device``, with the
full per-candidate state resident there.  On a CUDA device the step's
commit (pool select + slot argmin + clock/busy/seen update) is the
hand-written kernel :func:`repro_torch.kernels.lockstep_step.step_commit`;
every other operation of the step is a PyTorch operation.

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
* **Divergence falls back to the exact path.**  The same per-step heap-key
  monotonicity check as batchsim runs inside the loop (carried ``prev_key``
  per lane); lanes whose popped ``(ready_t, tie_break)`` keys ever violate
  it are flagged, their state is discarded, and they are re-simulated
  through :func:`~repro_torch.core.fastsim.simulate_fast`.
* **Fixed-bucket lane chunking.**  Lanes are evaluated in chunks padded to
  power-of-two widths (``chunk`` caps the bucket — non-power-of-two caps
  round *down* to a power of two); padding lanes replicate a real lane and
  are dropped before assembly.

The multi-graph megabatch (:func:`simulate_torch_many`) serves every graph
family of a sweep in one lane axis: heterogeneous ``(graph, order)``
cohorts are padded along the task axis to a shared ``[T, G, ...]``
step-input block with per-step validity masks, and each lane's cohort rows
are pre-gathered on the host.  The routing/discovery protocol around it is
:func:`repro_torch.core.replay.simulate_many`.

The device is never chosen here: ``device`` defaults to
:func:`repro_torch.default_device` (the card), a missing card raises
:class:`repro_torch.DeviceError`, and so does a kernel that fails to build
or launch.  The CPU runs the engine only when asked (``device="cpu"``).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import DeviceError, default_device, require_cuda
from ..kernels.lockstep_step import step_commit
from ..testing import faults
from .devices import SystemConfig
from .fastsim import FrozenGraph
# TORCH_RTOL is re-exported here on purpose: it is this engine's tier.
from .replay import (BatchStats, TORCH_RTOL, Layout,  # noqa: F401
                     MAX_RESCUE_ROUNDS, MIN_LOCKSTEP, PruneContext,
                     RESCUE_MIN, ReplayLibrary, graph_aux, lane_results,
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


def _run(xs: Dict[str, torch.Tensor], clocks: torch.Tensor,
         ready: torch.Tensor, placement: torch.Tensor, busy: torch.Tensor,
         seen: torch.Tensor, kind_pool: torch.Tensor, smp_kid: torch.Tensor,
         eft: bool):
    """The whole scan over ``T`` steps; the port of jaxsim's ``_runner``.

    Step inputs ``xs`` are lane-aligned (``[T, B, ...]`` — each lane's
    cohort rows pre-gathered on the host by :func:`_scan_cohorts`) and
    per-step ``valid`` masks make the task-axis padding inert.  ``clocks``,
    ``ready``, ``placement``, ``busy`` and ``seen`` are updated in place.
    Returns ``(makespan, busy, seen, placement, div)``."""
    B = clocks.shape[2]
    dev = clocks.device
    f64 = clocks.dtype
    K = xs["own_opts"].shape[2]

    def choose(opts, cost, rt, minc):
        """Vectorised reference `_choose_kind` over all lanes: options
        visited in annotation order, strict < on (key, pref) — the
        lowest-index winner, identical tie-breaks to the exact engines.
        ``minc [P, B]`` is the step's hoisted earliest-free-slot
        reduction."""
        best_k = torch.full((B,), -1, dtype=torch.int64, device=dev)
        bv = torch.zeros((B,), dtype=f64, device=dev)
        bp = torch.zeros((B,), dtype=f64, device=dev)
        for j in range(K):                      # K is tiny
            k = opts[:, j]
            kk = k.clamp(min=0)
            pi = _gather_lane(kind_pool, kk)
            valid = (k >= 0) & (pi >= 0)
            start = torch.maximum(rt, _gather_row(minc, pi.clamp(min=0)))
            keyv = start + _gather_lane(cost, kk) if eft else start
            pref = (k == smp_kid).to(f64)
            better = valid & ((best_k < 0) | (keyv < bv)
                              | ((keyv == bv) & (pref < bp)))
            bv = torch.where(better, keyv, bv)
            bp = torch.where(better, pref, bp)
            best_k = torch.where(better, k, best_k)
        return best_k

    makespan = torch.zeros((B,), dtype=f64, device=dev)
    prev_rt = torch.full((B,), -torch.inf, dtype=f64, device=dev)
    prev_tb = torch.full((B,), -1, dtype=torch.int64, device=dev)
    div = torch.zeros((B,), dtype=torch.bool, device=dev)
    names = tuple(xs)
    for step_x in zip(*(xs[k] for k in names)):
        x = dict(zip(names, step_x))
        valid = x["valid"]                                  # [B]
        r = x["r"]                       # dummy row n_max on invalid steps
        rt = _gather_row(ready, r)                          # [B]
        tbv = x["tb"]
        # heap-key monotonicity: a lane whose popped (ready_t, tb) key
        # ever fails to strictly increase is not executing its own heap
        # order — flag it for the exact fallback (and any lane that live-
        # executes a bad row, below)
        div |= valid & ((rt < prev_rt) | ((rt == prev_rt) & (tbv <= prev_tb)))

        # earliest-free slot per (pool, lane), shared by both choose passes
        minc = torch.amin(clocks, dim=1)                    # [P, B]

        # ---- conditional pass-through (per-lane mask) -------------------
        c = x["c"]
        has_cond = (c >= 0) & valid
        cmax = c.clamp(min=0)
        pk_old = _gather_row(placement, cmax).long()        # [B]
        chosen_p = choose(x["par_opts"], x["par_cost"], rt, minc)
        pk = torch.where(pk_old < 0, chosen_p, pk_old)
        _set_row(placement, cmax,
                 torch.where(has_cond, pk, pk_old).to(placement.dtype))
        live = (~has_cond | _gather_lane(x["act"], pk.clamp(min=0))) & valid

        # ---- dispatch + commit for the lanes executing the row ----------
        k_own = _gather_row(placement, r).long()
        und = k_own < 0
        chosen_o = choose(x["own_opts"], x["own_cost"], rt, minc)
        is_comp = x["is_comp"]
        k = torch.where(is_comp, torch.where(und, chosen_o, k_own),
                        x["k_first"])
        _set_row(placement, r,
                 torch.where(is_comp & live & und, k, k_own
                             ).to(placement.dtype))
        div |= live & (x["bad_row"] | (k < 0))
        kk = k.clamp(min=0)
        p = _gather_lane(kind_pool, kk).clamp(min=0)        # [B]
        base = _gather_lane(x["own_cost"], kk)              # [B]
        end = step_commit(clocks, busy, seen, p, rt, base, live)
        end_eff = torch.where(live, end, torch.where(valid, rt, 0.0))
        makespan = torch.maximum(makespan, end_eff)
        succ = x["succ"]                                    # [SC, B]
        ready.scatter_reduce_(0, succ, end_eff.unsqueeze(0).expand_as(succ),
                              reduce="amax", include_self=True)
        prev_rt = torch.where(valid, rt, prev_rt)
        prev_tb = torch.where(valid, tbv, prev_tb)
    return makespan, busy, seen, placement, div


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
    (_uids, _ci, _cond, dev_first, dev_opts, _asets, costs, _succs,
     _npred, is_comp, *_rest) = fg._runtime()
    bad = np.zeros(fg.n, dtype=bool)
    for r in range(fg.n):
        if is_comp[r]:
            any_pool = False
            for k in dev_opts[r]:
                if kind_pool[k] < 0:
                    continue
                any_pool = True
                if costs[r][k] != costs[r][k]:      # NaN on eligible option
                    bad[r] = True
            bad[r] |= not any_pool
        else:
            k0 = dev_first[r]
            bad[r] = kind_pool[k0] < 0 or costs[r][k0] != costs[r][k0]
    return bad


# Per-FrozenGraph cap on memoised (order, kind_pool) -> xs entries (the
# replay library's per-key order cap).
_XS_CACHE_CAP = 32


def _pool_caps(fg: FrozenGraph, order: Sequence[int],
               kind_pool: Sequence[int], P: int) -> np.ndarray:
    """``int[P]``: how many rows of ``order`` could *ever* dispatch to each
    pool — computes count toward every eligible pool, non-computes toward
    their device's pool.

    This bounds the slot axis exactly: slots are claimed in prefix order
    (the commit's first-minimum argmin always prefers the lowest-index
    free slot, and every slot starts free), so a pool that receives at
    most ``m`` dispatches can never touch slot ``m`` or beyond.  Memoised
    per (order, kind_pool) beside :func:`_group_xs`."""
    cache = getattr(fg, "_torch_caps", None)
    if cache is None:
        cache = fg._torch_caps = {}
    ckey = (tuple(order), tuple(kind_pool), P)
    cached = cache.get(ckey)
    if cached is not None:
        return cached
    (_uids, _ci, _cond, dev_first, dev_opts, _asets, _costs, _succs,
     _npred, is_comp, *_rest) = fg._runtime()
    cap = np.zeros(P, dtype=np.int64)
    for r in order:
        for k in (dev_opts[r] if is_comp[r] else (dev_first[r],)):
            p = kind_pool[k]
            if p >= 0:
                cap[p] += 1
    if len(cache) >= _XS_CACHE_CAP:
        cache.pop(next(iter(cache)))
    cache[ckey] = cap
    return cap


def _group_xs(fg: FrozenGraph, order: Sequence[int],
              kind_pool: Sequence[int]) -> Dict[str, np.ndarray]:
    """Per-step inputs shared by every lane of the cohort, in replay order:
    row ids, tie-break scalars, conditional parents, device options and
    cost rows for the row *and* its conditional parent, activation-mask
    rows, bad-dispatch flags (:func:`_bad_rows`), and padded successor
    lists (pad = ``n``, a dummy ready row — remapped to the megabatch dummy
    by :func:`_scan_cohorts`).  Memoised on the FrozenGraph; dropped on
    pickling."""
    cache = getattr(fg, "_torch_xs", None)
    if cache is None:
        cache = fg._torch_xs = {}
    ckey = (tuple(order), tuple(kind_pool))
    cached = cache.get(ckey)
    if cached is not None:
        return cached
    (uids, ci, cond, dev_first, dev_opts, asets, costs, succs,
     _npred, is_comp, rankmaps, *_rest) = fg._runtime()
    n = fg.n
    tb, act_mask = graph_aux(fg, ci, rankmaps[0], asets)
    cost_np = fg.cost
    T = len(order)
    K = max(1, max(len(dev_opts[i]) for i in range(n)) if n else 1)
    S_max = max(1, max((len(succs[i]) for i in range(n)), default=1))
    n_kinds = len(fg.kinds)

    xs = {
        "r": np.empty(T, dtype=np.int64),
        "tb": np.empty(T, dtype=np.int64),
        "c": np.empty(T, dtype=np.int64),
        "is_comp": np.empty(T, dtype=bool),
        "k_first": np.empty(T, dtype=np.int64),
        "own_opts": np.full((T, K), -1, dtype=np.int64),
        "own_cost": np.zeros((T, n_kinds), dtype=np.float64),
        "par_opts": np.full((T, K), -1, dtype=np.int64),
        "par_cost": np.zeros((T, n_kinds), dtype=np.float64),
        "act": np.zeros((T, n_kinds), dtype=bool),
        "bad_row": _bad_rows(fg, kind_pool)[list(order)],
        "succ": np.full((T, S_max), n, dtype=np.int64),
    }
    for t, r in enumerate(order):
        xs["r"][t] = r
        xs["tb"][t] = tb[r]
        c = cond[r]
        xs["c"][t] = c
        xs["is_comp"][t] = is_comp[r]
        xs["k_first"][t] = dev_first[r]
        xs["own_opts"][t, :len(dev_opts[r])] = dev_opts[r]
        xs["own_cost"][t] = cost_np[r]
        if c >= 0:
            xs["par_opts"][t, :len(dev_opts[c])] = dev_opts[c]
            xs["par_cost"][t] = cost_np[c]
            xs["act"][t] = act_mask[r]
        if succs[r]:
            xs["succ"][t, :len(succs[r])] = succs[r]
    # bad-row flags capture every NaN a live dispatch could reach; scrub
    # the rest so no masked-out lane arithmetic can produce a NaN
    np.nan_to_num(xs["own_cost"], copy=False)
    np.nan_to_num(xs["par_cost"], copy=False)
    if len(cache) >= _XS_CACHE_CAP:
        cache.pop(next(iter(cache)))
    cache[ckey] = xs
    return xs


# Lane-aligned device blocks, memoised across _scan_cohorts calls: keyed by
# device, content (per-cohort graph hash × order × pool template),
# megabatch dims and the slice's cohort-index vector.  The cap bounds
# residency, LRU evicts.
_DEV_XS_CACHE: "collections.OrderedDict[Tuple, Tuple]" = \
    collections.OrderedDict()
_DEV_XS_CACHE_CAP = 16


# ---------------------------------------------------------------------------
# Cohort driver: task-axis padding, chunked lanes, shared step loop
# ---------------------------------------------------------------------------


def _scan_cohorts(cohorts: Sequence[Tuple[FrozenGraph, Sequence[int],
                                          Sequence[Layout],
                                          Optional[np.ndarray]]],
                  policy: str, *, chunk: int, device: torch.device,
                  slot_bucketed: bool = False
                  ) -> List[Tuple[Dict[int, SimResult], List[int],
                                  Dict[int, float]]]:
    """Drive every lane of every ``(fg, order, layouts, cutoffs)`` cohort
    through the shared step loop on ``device``.

    Task-axis padding layout: per-cohort step inputs (:func:`_group_xs`)
    are stacked into ``[T_max, G, ...]`` blocks — steps beyond a cohort's
    own length carry ``valid=False``, the dummy row id ``n_max`` and
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

    per = []
    for fg, order, layouts, cuts in cohorts:
        pool_names, _, kind_pool = layouts[0]           # template-shared
        kinds = fg.kinds
        caps = _pool_caps(fg, order, kind_pool, len(pool_names))
        lane_counts = [lay[1] for lay in layouts]
        per.append({
            "fg": fg, "xs": _group_xs(fg, order, kind_pool), "cuts": cuts,
            "pool_names": pool_names, "kind_pool": list(kind_pool),
            "smp_kid": kinds.index("smp") if "smp" in kinds else -1,
            "lane_counts": lane_counts,
            # slot-axis need per lane: pool slot counts clamped to the
            # dispatch caps (exact — see _pool_caps)
            "needs": [max(1, max((min(int(c), int(caps[p]))
                                  for p, c in enumerate(cnt)), default=1))
                      for cnt in lane_counts],
            "n": fg.n, "P": len(pool_names),
        })
    G = len(per)
    n_max = max(c["n"] for c in per)
    P_max = max(c["P"] for c in per)
    T_max = max(len(c["xs"]["r"]) for c in per)
    K = max(c["xs"]["own_opts"].shape[1] for c in per)
    NK = max(len(c["kind_pool"]) for c in per)
    SC = max(c["xs"]["succ"].shape[1] for c in per)
    S = _bucket(max(nd for c in per for nd in c["needs"]), cap=1 << 30)

    kind_pool_m = np.full((G, NK), -1, dtype=np.int64)
    smp_kid_m = np.full((G,), -1, dtype=np.int64)
    for gi, c in enumerate(per):
        nk = len(c["kind_pool"])
        kind_pool_m[gi, :nk] = c["kind_pool"]
        smp_kid_m[gi] = c["smp_kid"]

    _mega_memo: List[Optional[Dict[str, np.ndarray]]] = [None]

    def _mega() -> Dict[str, np.ndarray]:
        """The ``[T_max, G, ...]`` task-axis-padded step-input stack, built
        lazily: a warm repeat sweep whose slices all hit the device cache
        never stacks it at all."""
        if _mega_memo[0] is not None:
            return _mega_memo[0]
        mega = {
            "valid": np.zeros((T_max, G), dtype=bool),
            "r": np.full((T_max, G), n_max, dtype=np.int64),
            "tb": np.zeros((T_max, G), dtype=np.int64),
            "c": np.full((T_max, G), -1, dtype=np.int64),
            "is_comp": np.zeros((T_max, G), dtype=bool),
            "k_first": np.zeros((T_max, G), dtype=np.int64),
            "own_opts": np.full((T_max, G, K), -1, dtype=np.int64),
            "own_cost": np.zeros((T_max, G, NK), dtype=np.float64),
            "par_opts": np.full((T_max, G, K), -1, dtype=np.int64),
            "par_cost": np.zeros((T_max, G, NK), dtype=np.float64),
            "act": np.zeros((T_max, G, NK), dtype=bool),
            "bad_row": np.zeros((T_max, G), dtype=bool),
            "succ": np.full((T_max, SC, G), n_max, dtype=np.int64),
        }
        for gi, c in enumerate(per):
            xs = c["xs"]
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
            # stored [T, SC, lanes] so each step's index block is the
            # [SC, B] shape scatter_reduce_ takes along the task axis.
            mega["succ"][:T, :sc, gi] = np.where(xs["succ"] == n, n_max,
                                                 xs["succ"])
        _mega_memo[0] = mega
        return mega

    # cache key prefix for the lane-aligned device blocks: content-based,
    # so repeat sweeps hit it across fresh Explorers
    base_key = (str(device),
                tuple((c["fg"].content_hash(), tuple(c["xs"]["r"]),
                       tuple(c["kind_pool"])) for c in per),
                (T_max, n_max, P_max, K, NK, SC),
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
        and capped by ``chunk``."""
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

    def _lane_aligned(g_np: np.ndarray) -> Tuple:
        """Step inputs gathered per lane (``[T, B, ...]``; successors
        ``[T, SC, B]``) on ``device``, memoised per cohort-index vector."""
        key = (base_key, g_np.tobytes())
        hit = _DEV_XS_CACHE.get(key)
        if hit is None:
            mega = _mega()
            xs_d = {}
            for k, v in mega.items():
                lanes = v[:, :, g_np] if k == "succ" else v[:, g_np]
                xs_d[k] = torch.from_numpy(
                    np.ascontiguousarray(lanes)).to(device)
            hit = (xs_d, torch.from_numpy(kind_pool_m[g_np]).to(device),
                   torch.from_numpy(smp_kid_m[g_np]).to(device))
            if len(_DEV_XS_CACHE) >= _DEV_XS_CACHE_CAP:
                _DEV_XS_CACHE.popitem(last=False)
            _DEV_XS_CACHE[key] = hit
        else:
            _DEV_XS_CACHE.move_to_end(key)
        return hit

    for sl, S_sl in slices:
        B = _bucket(len(sl), cap=chunk)
        # pad lanes replicate the last real lane: finite, well-defined
        # state whose results are simply dropped before assembly
        padded = sl + [sl[-1]] * (B - len(sl))
        g_np = np.fromiter((gi for gi, _ in padded), dtype=np.int64, count=B)
        clocks = np.full((P_max, S_sl, B), np.inf)
        for li, (gi, pos) in enumerate(padded):
            for p, cnt in enumerate(per[gi]["lane_counts"][pos]):
                clocks[p, :cnt, li] = 0.0
        try:
            xs_d, kp_d, sk_d = _lane_aligned(g_np)
            makespan, busy, seen, placement, div = _run(
                xs_d, torch.from_numpy(clocks).to(device),
                torch.zeros((n_max + 1, B), dtype=torch.float64,
                            device=device),
                torch.full((n_max + 1, B), -1, dtype=torch.int32,
                           device=device),
                torch.zeros((P_max, B), dtype=torch.float64, device=device),
                torch.zeros((P_max, B), dtype=torch.bool, device=device),
                kp_d, sk_d, eft)
            div_np = div.cpu().numpy()
            mk_np, busy_np = makespan.cpu().numpy(), busy.cpu().numpy()
            seen_np, place_np = seen.cpu().numpy(), placement.cpu().numpy()
        except _CARD_ERRORS as exc:
            raise DeviceError(f"the device failed in the torch step loop "
                              f"on {device}: {exc}") from exc
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
            acc["place"].append(place_np[:c["n"], li:li + 1])

    results: List[Tuple[Dict[int, SimResult], List[int],
                        Dict[int, float]]] = []
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
    return results


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def simulate_torch(fg: FrozenGraph, systems: Sequence[SystemConfig],
                   policy: str = "availability", *,
                   device: DeviceLike = None,
                   min_lockstep: int = MIN_LOCKSTEP,
                   chunk: int = DEFAULT_CHUNK,
                   stats: Optional[BatchStats] = None,
                   library: Optional[ReplayLibrary] = None,
                   max_rounds: int = MAX_RESCUE_ROUNDS,
                   rescue_min: int = RESCUE_MIN,
                   prune: Optional[PruneContext] = None):
    """Schedule-free :class:`SimResult` per system, in input order.

    The torch tier of :func:`repro_torch.core.batchsim.simulate_batch`:
    equivalent to ``[simulate_fast(fg, s, policy) for s in systems]`` at
    :data:`~repro_torch.core.replay.TORCH_RTOL` relative makespan/busy
    error with identical placements, and ranking-stable under the
    documented tie-break.  Grouping, multi-order library replay and the
    per-lane exact fallback are the shared :mod:`repro_torch.core.replay`
    protocol; ``chunk`` caps the lane-bucket width (non-power-of-two caps
    round down).  ``device`` defaults to the card.

    ``prune`` enables lane retirement
    (:class:`~repro_torch.core.replay.PruneContext`): lanes whose makespan
    exceeds the incumbent cutoff, pre-inflated by the engine's tolerance,
    come back as :class:`~repro_torch.core.replay.Retired` markers."""
    dev = resolve_device(device)
    require_torch()
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk!r}")

    def lockstep(fg, order, layouts, policy, cutoffs=None):
        (triple,) = _scan_cohorts([(fg, order, layouts, cutoffs)], policy,
                                  chunk=chunk, device=dev)
        return triple

    return simulate_grouped(fg, systems, policy, min_lockstep=min_lockstep,
                            stats=stats, library=library,
                            max_rounds=max_rounds, rescue_min=rescue_min,
                            lockstep_fn=lockstep, prune=prune)


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
                        = None) -> List[List[SimResult]]:
    """Multi-graph megabatch: every ``(graph, systems)`` family of a sweep
    through one shared lane axis.

    Per family the results match ``simulate_torch(fg, systems, ...)`` at
    the same tier — routing, discovery and the exact serial fallback are
    :func:`repro_torch.core.replay.simulate_many` — but heterogeneous
    graphs share the lane axis (task-axis padding, host-side lane-aligned
    pre-gather, slot-bucketed slices).  ``chunk`` defaults to
    :data:`MEGABATCH_CHUNK`."""
    dev = resolve_device(device)
    require_torch()
    chunk = MEGABATCH_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk!r}")

    def lockstep_many(cohorts):
        return _scan_cohorts(cohorts, policy, chunk=chunk, device=dev,
                             slot_bucketed=True)

    return simulate_many(items, policy, lockstep_many_fn=lockstep_many,
                         min_lockstep=min_lockstep, stats=stats,
                         library=library, max_rounds=max_rounds,
                         prunes=prunes)
