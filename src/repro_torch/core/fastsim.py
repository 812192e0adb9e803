"""Array-compiled batch simulator — the §IV engine, flattened for sweeps.

The reference :class:`~repro_torch.core.simulator.Simulator` walks the augmented
graph as Python objects: dict lookups per task, a ``meta`` dict probe per
dispatch, a :class:`ScheduledTask` dataclass per event.  That is the right
shape for one estimate and the wrong shape for a 200-candidate co-design
sweep, where the *loop* is the product (CEDR-style scheduler×accelerator
grids, hardware-HEFT batch ranking).

This module compiles the graph once into a :class:`FrozenGraph` —
structure-of-arrays: CSR successor adjacency, a dense per-kind cost matrix,
integer role/conditional/eligibility columns — and drives the same
event-driven list-scheduling semantics over flat arrays
(:func:`simulate_fast`).  Two properties are load-bearing:

* **Bit-identical results.**  ``simulate_fast`` performs the exact floating
  point operations of ``Simulator.run`` in the exact order (same heap keys,
  same tie-breaks, same ``max``/``+`` sequencing), so makespans, placements
  and busy-time sums are ``==`` to the reference — pinned by randomized
  tests under both policies, with and without conditional DMA tasks.
* **Shared across slot variants.**  A ``FrozenGraph`` depends on the same
  things the exploration engine's graph cache key depends on (eligibility ×
  cost-relevant system knobs) — pool *counts* bind only at simulate time,
  so a 1-accelerator and a 4-accelerator candidate share one frozen payload.
  The payload is numpy-backed and picklable: the :class:`Explorer` ships it
  to ``ProcessPoolExecutor`` workers and persists it in the on-disk sweep
  store.

``with_schedule=False`` (schedule-free mode) skips materialising
:class:`ScheduledTask` records entirely — makespan, per-pool busy time and
placements only — which is what exploration ranks on; full records are
rebuilt just for the top-k winners.

Division of labour with the candidate-axis engines: this module is the
*one-candidate* fast path (and the bit-identity anchor every other engine
is pinned against); :mod:`repro_torch.core.batchsim` (numpy lockstep) and
:mod:`repro_torch.core.torchsim` (jit-compiled ``lax.scan``, rtol tier) stack
*all* candidates sharing one ``FrozenGraph`` on a dedicated candidate
axis and advance them through one replayed event order, falling back to
:func:`simulate_fast` per lane whenever a candidate's order diverges —
so ``simulate_fast`` is every batch backend's reference-order recorder
(``order_out=``) and exact escape hatch.  The shared replay protocol and
the engine equivalence tiers live in :mod:`repro_torch.core.replay`; the
architecture overview in ``docs/architecture.md``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from heapq import heapify, heappop, heappush
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .devices import SystemConfig
from .simulator import ScheduledTask, SimResult, validate_pools
from .taskgraph import TaskGraph


@dataclasses.dataclass
class FrozenGraph:
    """Structure-of-arrays snapshot of one augmented :class:`TaskGraph`.

    Rows are tasks in graph insertion order (the reference simulator's
    iteration order); ``kinds`` is the device-kind universe of this graph and
    every per-kind column indexes into it.  All arrays are numpy (compact,
    picklable); scalar-hot access happens through a lazily built plain-list
    mirror that is dropped on pickling.
    """

    n: int
    uid: np.ndarray             # int64[n] — original task uids
    names: Tuple[str, ...]      # per-row task name (schedule records)
    roles: Tuple[str, ...]      # per-row role string (schedule records)
    is_compute: np.ndarray      # bool[n]
    creation_index: np.ndarray  # int64[n]
    cond: np.ndarray            # int64[n] — row of conditional parent, or -1
    act_indptr: np.ndarray      # CSR: active kind-ids per conditional row
    act_kids: np.ndarray
    dev_indptr: np.ndarray      # CSR: device options (kind-ids, pragma order)
    dev_kids: np.ndarray
    cost: np.ndarray            # float64[n, n_kinds]; NaN where undefined
    succ_indptr: np.ndarray     # CSR successor rows (sorted)
    succ_rows: np.ndarray
    n_pred: np.ndarray          # int64[n]
    kinds: Tuple[str, ...]      # kind-id -> kind name
    # graph metadata the exploration engine needs without the TaskGraph
    stats: Dict[str, object]
    critical_path_s: float
    lower_bound_s: float

    # ------------------------------------------------------------------
    @staticmethod
    def freeze(graph: TaskGraph) -> "FrozenGraph":
        rows = list(graph.tasks.values())
        idx_of = {t.uid: i for i, t in enumerate(rows)}
        n = len(rows)

        kinds: List[str] = []
        kind_id: Dict[str, int] = {}

        def kid(k: str) -> int:
            i = kind_id.get(k)
            if i is None:
                i = kind_id[k] = len(kinds)
                kinds.append(k)
            return i

        uid = np.empty(n, dtype=np.int64)
        is_compute = np.zeros(n, dtype=bool)
        creation_index = np.empty(n, dtype=np.int64)
        cond = np.full(n, -1, dtype=np.int64)
        names: List[str] = []
        roles: List[str] = []
        act_indptr = np.zeros(n + 1, dtype=np.int64)
        act_kids: List[int] = []
        dev_indptr = np.zeros(n + 1, dtype=np.int64)
        dev_kids: List[int] = []
        succ_indptr = np.zeros(n + 1, dtype=np.int64)
        succ_rows: List[int] = []
        n_pred = np.empty(n, dtype=np.int64)

        for i, t in enumerate(rows):
            uid[i] = t.uid
            names.append(t.name)
            role = t.role
            roles.append(role)
            is_compute[i] = role == "compute"
            creation_index[i] = t.creation_index
            c = t.meta.get("conditional_on")
            if c is not None:
                cond[i] = idx_of[int(c)]
            for k in t.meta.get("active_kinds", ()):
                act_kids.append(kid(k))
            act_indptr[i + 1] = len(act_kids)
            for k in t.devices:
                dev_kids.append(kid(k))
            dev_indptr[i + 1] = len(dev_kids)
            for k in t.costs:
                kid(k)
            succ_rows.extend(sorted(idx_of[v] for v in graph.succ.get(t.uid, ())))
            succ_indptr[i + 1] = len(succ_rows)
            n_pred[i] = len(graph.pred.get(t.uid, ()))

        cost = np.full((n, len(kinds)), np.nan, dtype=np.float64)
        for i, t in enumerate(rows):
            for k, c in t.costs.items():
                cost[i, kind_id[k]] = c

        from .augment import lower_bound_cost

        try:
            crit, lb = graph.critical_paths([None, lower_bound_cost])
        except ValueError:
            # cyclic graph: freeze anyway — the simulator reports the
            # deadlock at run time, exactly like the reference engine
            crit = lb = float("nan")

        return FrozenGraph(
            n=n, uid=uid, names=tuple(names), roles=tuple(roles),
            is_compute=is_compute, creation_index=creation_index, cond=cond,
            act_indptr=act_indptr, act_kids=np.asarray(act_kids, dtype=np.int64),
            dev_indptr=dev_indptr, dev_kids=np.asarray(dev_kids, dtype=np.int64),
            cost=cost, succ_indptr=succ_indptr,
            succ_rows=np.asarray(succ_rows, dtype=np.int64),
            n_pred=n_pred, kinds=tuple(kinds),
            stats=graph.subgraph_stats(),
            critical_path_s=crit, lower_bound_s=lb)

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_rt", None)          # plain-list mirror is rebuilt on use
        state.pop("_batch_aux", None)   # batchsim constants likewise
        state.pop("_torch_xs", None)    # torchsim scan inputs likewise
        state.pop("_torch_caps", None)  # torchsim slot caps likewise
        state.pop("_bound_aux", None)   # retirement bound tables likewise
        state.pop("_serial_tails", None)    # serial-abort tail list likewise
        return state

    def _runtime(self):
        """Plain-python mirror of the hot arrays (numpy scalar indexing is
        ~10× slower than list indexing inside the event loop).  Adjacency and
        device options come pre-sliced per row so the loop never re-slices."""
        rt = getattr(self, "_rt", None)
        if rt is None:
            n = self.n
            acti = self.act_indptr.tolist()
            actk = self.act_kids.tolist()
            devi = self.dev_indptr.tolist()
            devk = self.dev_kids.tolist()
            succi = self.succ_indptr.tolist()
            succr = self.succ_rows.tolist()
            rt = (
                self.uid.tolist(),
                self.creation_index.tolist(),
                self.cond.tolist(),
                [devk[devi[i]] for i in range(n)],                  # dev_first
                [devk[devi[i]:devi[i + 1]] for i in range(n)],      # dev_opts
                [frozenset(actk[acti[i]:acti[i + 1]]) for i in range(n)],
                self.cost.tolist(),
                [succr[succi[i]:succi[i + 1]] for i in range(n)],   # succs
                self.n_pred.tolist(),
                self.is_compute.tolist(),
                self._rankmaps(),
            )
            npred, is_comp, rank, ci = rt[8], rt[9], rt[10][0], rt[1]
            # per-sim constants: pre-built root heap entries + compute rows
            rt = rt + (
                [(0.0, ci[i], rank[i]) for i in range(n) if npred[i] == 0],
                [i for i in range(n) if is_comp[i]],
            )
            self._rt = rt
        return rt

    def _rankmaps(self):
        """(rank, row_by_rank): a strictly uid-monotone relabeling of rows
        onto 0..n-1, so heap tie-breaks can use a compact int in place of
        the raw uid.  Identity when uids are already dense row indices."""
        uids = self.uid.tolist()
        if uids == list(range(self.n)):
            ident = list(range(self.n))
            return ident, ident
        order = sorted(range(self.n), key=uids.__getitem__)
        rank = [0] * self.n
        for r, i in enumerate(order):
            rank[i] = r
        return rank, order

    def content_hash(self) -> str:
        """sha256 over the simulation-determining content, memoised.

        This is the graph token of the multi-order replay library
        (:mod:`repro_torch.core.replay`) and of its on-disk order entries: two
        payloads with equal hashes replay each other's dispatch orders, so
        everything a heap order can depend on is hashed — the arrays plus
        the row/kind naming.  Derived metadata (``stats``, critical path)
        is excluded.  The memo is content-derived, so unlike ``_rt`` it
        survives pickling (workers reuse it instead of re-hashing).
        """
        h = getattr(self, "_content_hash", None)
        if h is None:
            m = hashlib.sha256()
            for a in (self.uid, self.is_compute, self.creation_index,
                      self.cond, self.act_indptr, self.act_kids,
                      self.dev_indptr, self.dev_kids, self.cost,
                      self.succ_indptr, self.succ_rows, self.n_pred):
                m.update(np.ascontiguousarray(a).tobytes())
            m.update(repr((self.n, self.names, self.roles,
                           self.kinds)).encode("utf-8"))
            h = self._content_hash = m.hexdigest()
        return h

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in (
            self.uid, self.creation_index, self.cond, self.act_indptr,
            self.act_kids, self.dev_indptr, self.dev_kids, self.cost,
            self.succ_indptr, self.succ_rows, self.n_pred))


def freeze_graph(graph: TaskGraph) -> FrozenGraph:
    """Module-level alias (reads better at call sites than the staticmethod)."""
    return FrozenGraph.freeze(graph)


# ---------------------------------------------------------------------------
# The array-driven event loop
# ---------------------------------------------------------------------------


def pool_layout(kinds: Sequence[str], system: SystemConfig
                ) -> Tuple[List[str], List[int], List[int]]:
    """``(pool_names, pool_counts, kind_pool)`` in ``Simulator.__init__``
    order: device pools first, shared resources after, first pool claiming
    a kind wins.  ``kind_pool[kid]`` is the pool index serving that kind id
    of ``kinds``, or ``-1`` when the system has no such pool.  Shared by
    ``simulate_fast`` and the batch engine so the two can never disagree on
    the dispatch target; runs the degenerate-candidate guard
    (:func:`repro_torch.core.simulator.validate_pools`) up front.
    """
    validate_pools(system)
    kid_of = {k: i for i, k in enumerate(kinds)}
    pools_spec = [(p.name, p.kinds, p.count) for p in system.pools] + \
                 [(r.name, (r.name,), r.count) for r in system.shared]
    pool_names: List[str] = []
    pool_counts: List[int] = []
    kind_pool = [-1] * len(kinds)
    for pi, (pname, pkinds, cnt) in enumerate(pools_spec):
        pool_names.append(pname)
        pool_counts.append(cnt)
        for k in pkinds:
            j = kid_of.get(k)
            if j is not None and kind_pool[j] < 0:
                kind_pool[j] = pi
    return pool_names, pool_counts, kind_pool


class LanePruned(Exception):
    """Raised by :func:`simulate_fast` when ``cutoff`` pruning is armed
    and the running makespan lower bound crossed it mid-loop.

    ``bound`` is the bound at abort time — a certified lower bound on the
    makespan this run would have produced (the serial prefix *is* the
    lane's true execution, so unlike the lockstep engines no
    prefix-exactness certificate is involved).  The partially-filled
    ``order_out`` of an aborted run must not be recorded as a replay
    order.
    """

    def __init__(self, bound: float):
        super().__init__(bound)
        self.bound = bound


def simulate_fast(fg: FrozenGraph, system: SystemConfig,
                  policy: str = "availability", *,
                  with_schedule: bool = False,
                  order_out: Optional[List[int]] = None,
                  cutoff: Optional[float] = None,
                  bound_tails: Optional[Sequence[float]] = None) -> SimResult:
    """Run the reference list-scheduling semantics over a FrozenGraph.

    Bit-identical to ``Simulator(graph, system, policy).run()`` (no
    ``time_model`` — the fast path exists for coarse sweeps; fine-grain
    reference runs keep the object engine).  ``with_schedule=False`` skips
    :class:`ScheduledTask` materialisation: ``SimResult.schedule`` is empty
    and placement counts are derived from ``placements``.

    ``order_out`` — optional list the dispatch order (graph row indices,
    heap pop order) is appended to; the batch engine records its reference
    order this way without paying for full schedule records.

    ``cutoff`` + ``bound_tails`` arm branch-and-bound retirement: after
    each executed task ``i`` the loop folds ``end_i + bound_tails[i]``
    (``bound_tails`` is the max min-cost critical path through ``i``'s
    successors — :func:`repro_torch.core.replay.bound_aux`'s ``tsm`` column, a
    certified remaining-work floor for *any* slot configuration) and
    raises :class:`LanePruned` the moment it exceeds ``cutoff``, instead
    of simulating a provably-beaten candidate to completion.
    """
    if policy not in ("availability", "eft"):
        raise ValueError(f"unknown policy {policy!r}")
    eft = policy == "eft"
    kinds = fg.kinds
    smp_kid = kinds.index("smp") if "smp" in kinds else -1

    pool_names, pool_counts, kind_pool = pool_layout(kinds, system)
    clocks: List[List[float]] = [[0.0] * cnt for cnt in pool_counts]

    (uids, ci, cond, dev_first, dev_opts, asets, costs, succs,
     n_pred0, is_comp, rankmaps, heap0, comp_rows) = fg._runtime()
    n = fg.n
    npred = list(n_pred0)
    ready = [0.0] * n
    placement = [-1] * n
    np_pools = len(pool_names)
    busy_v = [0.0] * np_pools
    busy_seen = [False] * np_pools
    single = [c == 1 for c in pool_counts]
    schedule: Optional[List[ScheduledTask]] = [] if with_schedule else None
    names, roles = fg.names, fg.roles
    push, pop = heappush, heappop

    def choose(row: int, rt: float) -> int:
        """Scheduling policy for a compute row — reference `_choose_kind`.

        Ties break exactly like the reference's ``(start[, +cost], pref,
        idx)`` tuple sort: options are visited in annotation order, so a
        strict ``<`` on (key, pref) keeps the lowest index."""
        best_k = -1
        bv = bp = 0.0
        crow = costs[row]
        for k in dev_opts[row]:
            pi = kind_pool[k]
            if pi < 0:
                continue
            base = crow[k]
            if base != base:        # NaN — reference cost_on would KeyError
                raise KeyError(
                    f"task {names[row]}#{uids[row]} has no cost for device "
                    f"kind {kinds[k]!r}")
            cl = clocks[pi]
            t = cl[0] if single[pi] else min(cl)
            start = rt if rt > t else t
            keyv = start + base if eft else start
            pref = 1 if k == smp_kid else 0
            if best_k < 0 or keyv < bv or (keyv == bv and pref < bp):
                bv, bp, best_k = keyv, pref, k
        if best_k < 0:
            raise RuntimeError(
                f"task {names[row]}#{uids[row]}: no compatible pool among "
                f"kinds {tuple(kinds[k] for k in dev_opts[row])}")
        return best_k

    # Heap keys replicate the reference's (ready_t, creation_index, uid)
    # total order.  `rank` is any strictly uid-monotone relabeling, so it
    # tie-breaks identically while keeping heap entries at three elements
    # (for build_graph output uids are dense and rank is the row index).
    rank, row_by_rank = rankmaps
    heap = list(heap0)           # root entries are per-graph constants
    heapify(heap)
    makespan = 0.0
    done = 0
    while heap:
        rt, _, r = pop(heap)
        i = row_by_rank[r]
        if order_out is not None:
            order_out.append(i)
        skipped = False
        c = cond[i]
        if c >= 0:
            pk = placement[c]
            if pk < 0:
                # first unit member to wake — decide the compute placement now
                pk = choose(c, rt)
                placement[c] = pk
            if pk not in asets[i]:
                # compute task went to the SMP → no DMA: zero-cost pass-through
                end = rt
                skipped = True
                if schedule is not None:
                    schedule.append(ScheduledTask(uids[i], names[i], "-", 0,
                                                  "skipped", rt, rt, roles[i]))
        if not skipped:
            if is_comp[i]:
                k = placement[i]
                if k < 0:
                    k = choose(i, rt)
                    placement[i] = k
            else:
                k = dev_first[i]
            pi = kind_pool[k]
            if pi < 0:
                raise KeyError(kinds[k])
            base = costs[i][k]
            if base != base:
                raise KeyError(
                    f"task {names[i]}#{uids[i]} has no cost for device kind "
                    f"{kinds[k]!r}")
            cl = clocks[pi]
            if single[pi]:
                t = cl[0]
                s = 0
            else:
                # C-level min + first-index == first-minimum argmin
                t = min(cl)
                s = cl.index(t)
            start = rt if rt > t else t
            end = start + base
            cl[s] = end
            busy_v[pi] += end - start
            busy_seen[pi] = True
            if schedule is not None:
                schedule.append(ScheduledTask(uids[i], names[i],
                                              pool_names[pi], s, kinds[k],
                                              start, end, roles[i]))
        if end > makespan:
            makespan = end
        if cutoff is not None:
            b = end + bound_tails[i]
            if b > cutoff:
                raise LanePruned(b)
        done += 1
        for j in succs[i]:
            if end > ready[j]:
                ready[j] = end
            d = npred[j] - 1
            npred[j] = d
            if d == 0:
                push(heap, (ready[j], ci[j], rank[j]))

    if done != n:
        raise RuntimeError(f"deadlock: executed {done}/{n} tasks")
    busy = {pool_names[pi]: busy_v[pi] for pi in range(np_pools)
            if busy_seen[pi]}
    placements = {uids[i]: kinds[placement[i]] for i in comp_rows
                  if placement[i] >= 0}
    return SimResult(
        makespan=makespan, schedule=schedule if schedule is not None else [],
        busy=busy,
        pool_slots={pool_names[pi]: pool_counts[pi] for pi in range(np_pools)},
        placements=placements, policy=policy, system=system.name)


def simulate_each(fg: FrozenGraph,
                  items: Sequence[Tuple[SystemConfig, str]], *,
                  with_schedule: bool = False) -> List[SimResult]:
    """Evaluate many (system, policy) variants of one frozen graph, one
    independent event loop per variant.

    Kept as the per-candidate baseline; the production sweep path is
    :func:`repro_torch.core.batchsim.simulate_batch`, which runs all variants of
    one graph in a single lockstep sweep and is what the explorer and the
    process-pool workers dispatch (this loop is what ``batchsim`` must beat,
    and what it degrades to lane-by-lane on event-order divergence).
    """
    return [simulate_fast(fg, system, policy, with_schedule=with_schedule)
            for system, policy in items]
