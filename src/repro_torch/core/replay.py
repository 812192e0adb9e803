"""Order-replay machinery shared by the candidate-axis engines.

Both lockstep backends (:mod:`repro_torch.core.batchsim` — numpy;
:mod:`repro_torch.core.torchsim` — a torch step loop over device tensors)
run the same
protocol around their inner sweep:

1. **Group** the candidate systems by *pool template* (pool names/kinds and
   the kind→pool map; slot counts are free to vary inside a group) — lanes
   in one group agree on which pool serves each device kind, so one
   dispatch-target table drives every lane.
2. **Replay** dispatch orders from a :class:`ReplayLibrary` — every order
   ever discovered for this (graph, pool template, policy) key, starting
   from the orders the library already holds and falling back to recording
   new ones through the bit-identical
   :func:`~repro_torch.core.fastsim.simulate_fast` path (``order_out=``).
3. **Validate** every lane against the heap-key monotonicity invariant (a
   lane's execution order equals its own heap order *iff* its popped
   ``(ready_t, tie_break)`` keys strictly increase along the replay) and
   **rescue** diverged lanes: their own orders are recorded once, appended
   to the library, and the diverged cohort is re-batched in lockstep
   against the new orders (bounded by ``max_rounds``); only when the
   library is full or the rounds budget is spent does a lane degrade to a
   plain serial ``simulate_fast`` run.  A diverged lane's lockstep state
   is always discarded, never resumed, so correctness does not depend on
   how late the divergence is caught.

The library also remembers, per replayed order, which *slot-count
signatures* passed it (`sig routing`): a warm sweep routes every lane
straight to the order its signature validated against last time — the
deterministic engines guarantee the same (graph, template, counts, policy)
always pops the same heap order — so repeat sweeps skip both the serial
reference run and the diverge-detect-resimulate cycle entirely.  Lanes
whose remembered order serves *only* them are evaluated straight through
the exact serial path (``order_pinned_lanes``): replaying a single lane in
lockstep costs more than the serial loop it replaces, so the library's win
for such a lane is skipping it out of a doomed lockstep, not vectorising
it.

**Own-order lanes.**  A backend that can step a lane through its *own*
heap order on its lane axis (the torch engine: a cohort whose order is
``None``) supplies that as the ``own_order_fn`` seam of
:func:`simulate_grouped` and :func:`simulate_many`.  With it, a lane the
protocol would send to the exact serial path without recording an order
— a small group, a pinned signature, a routed cohort too thin to replay,
a serial fallback — steps its own order in lockstep instead, and so do,
in the megabatch, a cold group's lanes after its first discovery.
Discoveries still run serially and record their orders (a group's first,
which seeds the library, and a lane that diverged from a replayed order:
in the megabatch one a group, the rest marked for the seam
(:meth:`ReplayLibrary.mark_own`, which nothing else reads) and stepped in
their own orders), as does a lane that live-dispatches a row the
reference raises on.  Routed cohorts of at least ``min_lockstep`` lanes still replay.
Without the seam (the numpy backend), under pruning or when schedules
are asked for, the protocol is the one above.

This module owns the protocol (grouping, order selection, rescue, fallback,
per-lane result assembly, the per-graph auxiliary constants) so the
backends can never disagree on it; each backend supplies only the inner
``lockstep_fn`` that advances the stacked per-candidate state, and the
torch engine its own-order seam.

It also owns the **engine equivalence tiers**: the exact engines
(``fast``/``batch``) are pinned bit-identical to the reference object
engine, while the torch engine is pinned at ``rtol``-level
(:data:`TORCH_RTOL` relative makespan error, ranking-stable with ties broken
deterministically by candidate submission order).  :func:`sims_equivalent`
and :func:`rankings_equivalent` are the single implementation of those
contracts, used by the test suite and the fig6 benchmark asserts alike.
Cached orders are **tier-agnostic**: every order is recorded by the exact
serial path, and each backend re-validates every lane against it, so a
library warmed by the batch engine serves the torch engine unchanged (and
vice versa) without laundering rtol results into the exact tier.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from collections import deque
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Set,
                    Tuple, Union)

import numpy as np

from .. import tracing
from .devices import SystemConfig
from .fastsim import FrozenGraph, LanePruned, pool_layout, simulate_fast
from .simulator import SimResult

# Below this many lanes per group the per-step dispatch overhead outweighs
# the vectorisation win and simulate_fast per lane is faster.
MIN_LOCKSTEP = 6

#: Max serial order *discoveries* (reference + rescue recordings) per
#: group call; past it the remaining diverged lanes degrade to plain
#: serial fallbacks with nothing recorded.
MAX_RESCUE_ROUNDS = 32

#: Rescue re-batches (lockstep re-runs of a diverged cohort against a
#: freshly discovered order) only start when the cohort is at least this
#: wide: one re-batch sweep costs roughly ten serial runs, so thin cohorts
#: are cheaper to discover serially — which still records their orders, so
#: the *next* sweep routes them without any lockstep gamble.
RESCUE_MIN = 24

#: Orders kept per (graph, template, policy) key; beyond it new orders are
#: not recorded (their lanes degrade to serial fallback) so a pathological
#: all-unique-order sweep cannot grow the library without bound.
MAX_ORDERS_PER_KEY = 32

#: Engine equivalence tiers: maximum relative makespan error vs the
#: reference object engine.  ``0.0`` means bit-identical (``==`` on floats);
#: the torch engine is relaxed to rtol because its device ops own their
#: own evaluation order.
ENGINE_TOLERANCE: Mapping[str, float] = {
    "reference": 0.0,
    "fast": 0.0,
    "batch": 0.0,
    "torch": 1e-6,
}

#: The torch engine's tier (``ENGINE_TOLERANCE["torch"]``), importable by
#: name.
TORCH_RTOL = ENGINE_TOLERANCE["torch"]

#: The declared degradation chain: when an engine *itself* faults (an
#: injected torch import failure, a lockstep engine bug)
#: the sweep demotes to the next engine and keeps going instead of dying —
#: each step moves toward fewer moving parts, and every step at or below
#: ``batch`` stays on the exact (bit-identical) tier, so a demoted sweep
#: can only *tighten* its equivalence tier, never relax it.  ``reference``
#: has no fallback: a failure there is a real error and propagates.
ENGINE_FALLBACK: Mapping[str, Optional[str]] = {
    "torch": "batch",
    "batch": "fast",
    "fast": "reference",
    "reference": None,
}

# A layout as produced by fastsim.pool_layout: (names, counts, kind_pool).
Layout = Tuple[List[str], List[int], List[int]]
# A backend's inner sweep: (fg, order, layouts, policy, cutoffs) ->
# ({lane position -> schedule-free SimResult with system=""}, [diverged
# lane positions], {lane position -> retirement bound}).  Positions index
# the *layouts* sequence.  ``cutoffs`` is a per-lane float array (or
# ``None`` = no pruning): a lane whose monotone partial bound exceeds its
# cutoff may be *retired* mid-sweep — its bound is a proven lower bound on
# its exact makespan, so the lane is provably outside the incumbent top-k.
LockstepFn = Callable[[FrozenGraph, Sequence[int], Sequence[Layout], str,
                       Optional[np.ndarray]],
                      Tuple[Dict[int, SimResult], List[int],
                            Dict[int, float]]]
# One megabatch cohort: every lane replays `order` over `fg` (the lanes
# share a pool template; slot counts vary per layout); the last element is
# the per-lane cutoff array (or None — no pruning for this cohort).
CohortSpec = Tuple[FrozenGraph, Tuple[int, ...], List[Layout],
                   Optional[np.ndarray]]
# A backend's megabatch sweep: all cohorts advance through ONE backend
# call; one (done, diverged, retired) triple per cohort, in the LockstepFn
# contract.
LockstepManyFn = Callable[[Sequence[CohortSpec]],
                          List[Tuple[Dict[int, SimResult], List[int],
                                     Dict[int, float]]]]
# The own-order seam is a LockstepFn / LockstepManyFn that also takes
# ``order=None``: each lane of such a cohort steps its own heap order, so
# none diverges; the lanes it reports in the diverged list live-dispatched
# a row the reference raises on (or never ran every row), for the exact
# path to report.


@dataclasses.dataclass
class BatchStats:
    """Observability for one or more grouped-simulation calls.

    Terminal lane classification (each lane counted exactly once):
    ``lockstep_lanes`` were fully evaluated inside a lockstep sweep;
    ``order_pinned_lanes`` were routed by the library straight to the exact
    serial path (their remembered order serves only them — see module
    docstring); ``reference_lanes`` ran serially through the schedule-free
    exact path *and recorded their order* into the library (the initial
    reference plus every rescue discovery); ``serial_fallback_lanes``
    ran serially with nothing recorded (rounds/library budget spent —
    the cost the library exists to eliminate); ``small_group_lanes`` never
    entered the protocol (group below ``min_lockstep``).

    Event counters (overlapping the above): ``diverged_lanes`` counts
    distinct lanes that failed at least one replay validation;
    ``rescued_lanes`` counts diverged lanes later completed in lockstep
    against another order; ``order_hits`` counts lanes completed against
    an order the library already held before the call (the warm-sweep
    figure of merit).

    Retirement counters (branch-and-bound pruning fused into the sweep):
    ``retired_lanes`` counts lanes retired mid-sweep because their
    monotone partial bound exceeded the incumbent cutoff (terminal, like
    the classification above — a retired lane is never rescued);
    ``retire_sweeps`` counts lockstep sweeps that retired at least one
    lane; ``incumbent_updates`` counts cutoff tightenings folded in from
    :class:`Incumbent` trackers (local and worker-side).

    ``own_order_lanes`` (an event counter, overlapping
    ``lockstep_lanes``) counts lanes a backend stepped through their own
    heap order on its lane axis (the ``own_order_fn`` seam), not through
    a replayed order.
    """

    groups: int = 0
    lockstep_lanes: int = 0
    diverged_lanes: int = 0
    rescued_lanes: int = 0
    order_hits: int = 0
    order_pinned_lanes: int = 0
    serial_fallback_lanes: int = 0
    small_group_lanes: int = 0
    reference_lanes: int = 0
    retired_lanes: int = 0
    retire_sweeps: int = 0
    incumbent_updates: int = 0
    own_order_lanes: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def add_dict(self, other: Mapping[str, int]) -> None:
        """Fold another call's counters in (process-pool workers report
        their BatchStats back as dicts)."""
        for k, v in other.items():
            if hasattr(self, k):
                setattr(self, k, getattr(self, k) + int(v))


# ---------------------------------------------------------------------------
# Branch-and-bound pruning: incumbent, cutoffs, retirement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Retired:
    """In-flight retirement marker, returned in a result slot instead of a
    :class:`~repro_torch.core.simulator.SimResult`: the lane's monotone partial
    bound exceeded its cutoff mid-sweep, so its final makespan provably
    exceeds the cutoff too.  ``bound`` is a true lower bound on the lane's
    exact makespan — the exploration layer reports it as
    ``status="pruned"`` (or ``"infeasible"`` when an energy cap retired
    the lane), never silently ranks it."""

    bound: float


class Incumbent:
    """Thread-safe k-th-best makespan tracker — the branch-and-bound
    incumbent shared across families, engines and process chunks.

    Offers are keyed by candidate name, so the same completion may be
    offered from both the engine (within-family tightening) and the
    exploration outcome seam (cross-family) without double counting; the
    cutoff is the k-th smallest offered makespan (``+inf`` until k
    candidates have completed), optionally capped by a ``seed`` shipped
    from a parent process at chunk-submit time.  A stale snapshot is
    always sound: the cutoff only tightens over time and retirement uses
    a strict ``bound > cutoff`` test, so a looser value can only retire
    fewer lanes — never a top-k member."""

    def __init__(self, k: int = 1, seed: Optional[float] = None):
        self.k = max(1, int(k))
        self.seed = float("inf") if seed is None else float(seed)
        self.updates = 0
        self._vals: Dict[str, float] = {}
        self._cut = float("inf")
        self._lock = threading.Lock()

    def deficit(self) -> int:
        """Completions still needed before the cutoff goes finite (0 when
        a parent seed already supplies one)."""
        with self._lock:
            if self.seed != float("inf"):
                return 0
            return max(0, self.k - len(self._vals))

    def get(self) -> float:
        """The current cutoff: any lane whose makespan provably exceeds
        it is outside the final top-k."""
        with self._lock:
            return min(self.seed, self._cut)

    def offer(self, name: str, makespan: float) -> bool:
        """Fold one completed candidate in; returns True when the cutoff
        tightened."""
        m = float(makespan)
        with self._lock:
            old = self._vals.get(name)
            if old is not None and old <= m:
                return False
            self._vals[name] = m
            if len(self._vals) >= self.k and m < self._cut:
                cut = heapq.nsmallest(self.k, self._vals.values())[-1]
                if cut < self._cut:
                    tightened = min(self.seed, cut) < min(self.seed,
                                                          self._cut)
                    self._cut = cut
                    if tightened:
                        self.updates += 1
                    return tightened
            return False


class PruneContext:
    """Pruning context threaded through the replay protocol into the
    lockstep backends: a live shared :class:`Incumbent` (the scalar top-k
    cutoff), optional static per-lane energy caps (``energy_cap /
    static_w`` — energy ``>= static_w × makespan >= static_w × bound``,
    so a bound past the cap proves infeasibility), and the engine's
    equivalence tolerance — non-zero tiers (torch) inflate the cutoff so a
    sub-tolerance tie can never be retired off the exact top-k."""

    __slots__ = ("incumbent", "caps", "tolerance")

    def __init__(self, incumbent: Optional[Incumbent] = None,
                 caps: Optional[np.ndarray] = None,
                 tolerance: float = 0.0):
        self.incumbent = incumbent
        self.caps = None if caps is None else np.asarray(caps, dtype=float)
        self.tolerance = float(tolerance)

    def subset(self, idx: Sequence[int]) -> "PruneContext":
        """The context for a subsequence of this call's lanes (shares the
        live incumbent; slices the static caps)."""
        if self.caps is None:
            return self
        return PruneContext(self.incumbent,
                            self.caps[np.asarray(idx, dtype=np.int64)],
                            self.tolerance)

    def cutoffs(self, lanes: Sequence[int]) -> Optional[np.ndarray]:
        """Per-lane cutoff array for ``lanes`` (positions into this
        context's lane space), re-reading the live incumbent; ``None``
        when nothing can retire (all cutoffs infinite)."""
        cut = self.incumbent.get() if self.incumbent is not None \
            else float("inf")
        c = np.full(len(lanes), cut)
        if self.caps is not None:
            np.minimum(c, self.caps[np.asarray(lanes, dtype=np.int64)],
                       out=c)
        if not np.isfinite(c).any():
            return None
        if self.tolerance:
            fin = np.isfinite(c)
            c[fin] *= 1.0 + 4.0 * self.tolerance
        return c

    def serial_cutoff(self, lane: int) -> Optional[float]:
        """The single-lane cutoff for a serial (``simulate_fast``) run —
        ``None`` when this lane cannot retire."""
        c = self.cutoffs([lane])
        return None if c is None else float(c[0])

    def offer(self, name: str, makespan: float) -> None:
        if self.incumbent is not None:
            self.incumbent.offer(name, makespan)

    def deficit(self) -> int:
        return self.incumbent.deficit() if self.incumbent is not None else 0


def bound_aux(fg: FrozenGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Static remainder table for the monotone partial bound, memoised on
    the FrozenGraph like ``_batch_aux`` (and dropped on pickling).

    ``tail[j]`` is the minimum possible critical path from ``j``
    *inclusive* to a sink — each row costed at its cheapest eligible kind,
    conditional rows at zero (they may be skipped) — and ``tsm[r] =
    max(tail[j] for j in succs(r))`` (0 at sinks).  For a lane whose
    replay is exact, every successor of the row finishing at ``end``
    becomes ready no earlier than ``end`` and must still run its own
    cheapest chain, so the lane's final makespan is ``>= end + tsm[row]``
    — the per-step quantity the engines fold into the running bound."""
    aux = getattr(fg, "_bound_aux", None)
    if aux is not None:
        return aux
    n = fg.n
    c = np.where(np.isnan(fg.cost), np.inf, fg.cost)
    minc = c.min(axis=1) if c.size else np.zeros(n)
    minc = np.where(np.isfinite(minc), minc, 0.0)
    minc[np.asarray(fg.cond) >= 0] = 0.0
    indptr = fg.succ_indptr.tolist()
    succ = fg.succ_rows.tolist()
    # Kahn topo order — row index is usually already topological, but the
    # bound's validity must not depend on that
    rem = fg.n_pred.tolist()
    dq = deque(i for i in range(n) if rem[i] == 0)
    topo: List[int] = []
    while dq:
        r = dq.popleft()
        topo.append(r)
        for j in succ[indptr[r]:indptr[r + 1]]:
            rem[j] -= 1
            if rem[j] == 0:
                dq.append(j)
    tail = np.zeros(n)
    tsm = np.zeros(n)
    for r in reversed(topo):      # rows on a cycle keep tail 0: still sound
        row = succ[indptr[r]:indptr[r + 1]]
        m = max((tail[j] for j in row), default=0.0)
        tsm[r] = m
        tail[r] = minc[r] + m
    fg._bound_aux = (tail, tsm)
    return tail, tsm


def serial_tails(fg: FrozenGraph) -> List[float]:
    """:func:`bound_aux`'s ``tsm`` column as a plain list (memoised,
    dropped on pickling) — the ``bound_tails`` argument of
    :func:`~repro_torch.core.fastsim.simulate_fast`'s cutoff mode."""
    t = getattr(fg, "_serial_tails", None)
    if t is None:
        t = fg._serial_tails = bound_aux(fg)[1].tolist()
    return t


def _serial_sim(fg: FrozenGraph, system, policy: str,
                prune: Optional[PruneContext], lane: int, *,
                with_schedule: bool = False,
                order_out: Optional[List[int]] = None
                ) -> Union[SimResult, Retired]:
    """The serial completion path of the replay protocol: an exact
    :func:`~repro_torch.core.fastsim.simulate_fast` run that, under a
    :class:`PruneContext`, retires itself the moment its monotone bound
    crosses the live cutoff.  The serial prefix *is* the lane's true
    execution, so no prefix-exactness certificate is needed — this is
    where pruning pays on ramp-shaped sweeps, whose slow lanes diverge
    out of lockstep and would otherwise re-simulate serially to
    completion.  Callers must not record the ``order_out`` of a run that
    came back :class:`Retired` (it is a partial order)."""
    cutoff = prune.serial_cutoff(lane) if prune is not None else None
    if cutoff is None:
        return simulate_fast(fg, system, policy,
                             with_schedule=with_schedule,
                             order_out=order_out)
    try:
        return simulate_fast(fg, system, policy,
                             with_schedule=with_schedule,
                             order_out=order_out, cutoff=cutoff,
                             bound_tails=serial_tails(fg))
    except LanePruned as e:
        return Retired(float(e.bound))


def _exact(fg: FrozenGraph, system, policy: str,
           prune: Optional[PruneContext], lane: int, **kw):
    """:func:`_serial_sim` as span ``replay.exact``; returns the result
    and the span, for :func:`_note`."""
    with tracing.span("replay.exact") as sp:
        return _serial_sim(fg, system, policy, prune, lane, **kw), sp


#: The :class:`BatchStats` counter of each cause of an exact run.
CAUSES = {"discover": "reference_lanes", "pinned": "order_pinned_lanes",
          "small_group": "small_group_lanes",
          "fallback": "serial_fallback_lanes"}


def _note(stats: Optional[BatchStats], sp, cause: str) -> None:
    """Count one lane's exact run under ``cause``: the ``cause`` of its
    ``replay.exact`` span and the :class:`BatchStats` counter of
    :data:`CAUSES`, together.  A retired run has none, but in a small
    group, which counts its lanes whole."""
    sp.set(cause=cause)
    if stats is not None:
        field = CAUSES[cause]
        setattr(stats, field, getattr(stats, field) + 1)


def _own_results(out, lanes: Sequence[int], systems, results: List,
                 exact: Callable, stats: Optional[BatchStats]) -> None:
    """The seam's ``(done, diverged, retired)`` for ``lanes`` (positions
    into ``systems``/``results``) stepped in their own orders: each done
    lane a lockstep lane and an own-order one; a lane reported diverged
    runs ``exact(i)``, which raises the reference's error or completes (a
    ``fallback``)."""
    done, bad, _ = out
    for pos, sim in done.items():
        i = lanes[pos]
        results[i] = dataclasses.replace(sim, system=systems[i].name)
        if stats is not None:
            stats.lockstep_lanes += 1
            stats.own_order_lanes += 1
    for pos in bad:
        results[lanes[pos]], sp = exact(lanes[pos])
        _note(stats, sp, "fallback")


def _own_order(fg: FrozenGraph, systems, layouts: Sequence[Layout],
               lanes: Sequence[int], policy: str,
               stats: Optional[BatchStats], own_fn: LockstepFn,
               results: List) -> None:
    """``lanes`` of one group through the backend's own-order seam, one
    call (:func:`_own_results`)."""
    if lanes:
        _own_results(own_fn(fg, None, [layouts[i] for i in lanes], policy,
                            None), lanes, systems, results,
                     lambda i: _exact(fg, systems[i], policy, None, i),
                     stats)


# ---------------------------------------------------------------------------
# The multi-order replay library
# ---------------------------------------------------------------------------


def order_valid(fg: FrozenGraph, order: Sequence[int]) -> bool:
    """Whether ``order`` is a topological permutation of ``fg``'s rows.

    The lockstep engines assume every replayed row's predecessors already
    executed (ready times would silently be wrong otherwise, and the
    monotonicity check cannot catch an under-informed ready time), so an
    order from a corrupted or stale library entry must be rejected *before*
    it is ever replayed — this is the corruption gate, run once per merge,
    O(n + E).
    """
    n = fg.n
    try:
        rows = [int(r) for r in order]
    except (TypeError, ValueError):
        return False
    if len(rows) != n:
        return False
    indptr = fg.succ_indptr.tolist()
    succ = fg.succ_rows.tolist()
    rem = fg.n_pred.tolist()
    seen = [False] * n
    for r in rows:
        if r < 0 or r >= n or seen[r] or rem[r] != 0:
            return False
        seen[r] = True
        for j in succ[indptr[r]:indptr[r + 1]]:
            rem[j] -= 1
    return True


# A library key: (graph content hash, (pool names, kind→pool map), policy).
LibraryKey = Tuple[str, Tuple[Tuple[str, ...], Tuple[int, ...]], str]
# A lane's slot-count signature inside one pool template.
CountsSig = Tuple[int, ...]


class _LibraryEntry:
    __slots__ = ("orders", "index", "sigs", "pins", "own")

    def __init__(self) -> None:
        self.orders: List[Tuple[int, ...]] = []
        self.index: Dict[Tuple[int, ...], int] = {}     # content -> position
        self.sigs: Dict[CountsSig, int] = {}            # counts -> position
        # signatures whose own heap order is not lockstep-provable (the
        # monotonicity check is conservative: zero-cost ties can pop a
        # smaller tie-break than a predecessor even in the lane's true
        # heap order) — route these straight to the exact serial path
        self.pins: Set[CountsSig] = set()
        # signatures that diverged from a library order and were stepped
        # in their own orders through a backend's own-order seam: only that
        # seam reads this set (never exported, never a pin)
        self.own: Set[CountsSig] = set()


class ReplayLibrary:
    """Cross-engine, cross-run cache of discovered dispatch orders.

    Keys are ``(graph content hash, pool template, policy)`` — everything a
    heap order depends on besides the per-lane slot counts — and each entry
    holds the orders discovered so far plus the *signature map*: which
    slot-count signature last validated against which order.  Because the
    engines are deterministic, a signature's remembered order is always its
    own heap order, so a warm :func:`replay_group` routes each lane straight
    to the right replay without a serial reference run.

    The library is a plain mutable object shared by engines, Explorers and
    sweeps; it is never pickled across processes — the worker protocol
    ships per-graph :meth:`export` payloads instead, and :meth:`merge`
    validates every incoming order against the graph
    (:func:`order_valid`) so corrupted or stale payloads degrade to a
    rediscovery, never to a wrong replay.
    """

    def __init__(self, max_orders_per_key: int = MAX_ORDERS_PER_KEY):
        self.max_orders_per_key = int(max_orders_per_key)
        self._entries: Dict[LibraryKey, _LibraryEntry] = {}
        self._dirty: Set[Tuple[str, str]] = set()       # (graph hash, policy)
        # export payloads of graphs not built yet, by (graph hash, policy)
        self._staged: Dict[Tuple[str, str], Mapping] = {}
        self._lock = threading.Lock()

    @staticmethod
    def key(fg: FrozenGraph, layout: Layout, policy: str) -> LibraryKey:
        names, _counts, kind_pool = layout
        return (fg.content_hash(), (tuple(names), tuple(kind_pool)), policy)

    # ------------------------------------------------------------------
    def lookup(self, key: LibraryKey
               ) -> Tuple[List[Tuple[int, ...]], Dict[CountsSig, int],
                          Set[CountsSig]]:
        """Snapshot of ``(orders, signature map, pinned signatures)``."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return [], {}, set()
            return list(e.orders), dict(e.sigs), set(e.pins)

    def record(self, key: LibraryKey, order: Sequence[int],
               sig: Optional[CountsSig] = None, *,
               mark: bool = True) -> Optional[int]:
        """Add ``order`` (dedup by content, capped per key); map ``sig`` to
        it.  Returns the order's position, or ``None`` when the key is full
        and the order is new — the caller's lane then counts as a serial
        fallback, not a recording.  ``mark=False`` (the merge-from-store
        path) skips the dirty flag so loading never schedules a write-back.
        """
        tup = tuple(int(r) for r in order)
        with self._lock:
            e = self._entries.setdefault(key, _LibraryEntry())
            pos = e.index.get(tup)
            changed = False
            if pos is None:
                if len(e.orders) >= self.max_orders_per_key:
                    return None
                pos = len(e.orders)
                e.orders.append(tup)
                e.index[tup] = pos
                changed = True
            if sig is not None and e.sigs.get(sig) != pos:
                e.sigs[sig] = pos
                changed = True
            if changed and mark:
                self._dirty.add((key[0], key[2]))
            return pos

    def map_sig(self, key: LibraryKey, sig: CountsSig, position: int, *,
                validated: bool = True, mark: bool = True) -> None:
        """Remember that ``sig`` ran against order ``position``.

        ``validated=True`` (a lockstep pass) also lifts any pin on the
        signature: the library now holds proof the signature can lockstep,
        so it must not stay parked on the serial path forever."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or not 0 <= position < len(e.orders):
                return
            changed = False
            if e.sigs.get(sig) != position:
                e.sigs[sig] = position
                changed = True
            if validated and sig in e.pins:
                e.pins.discard(sig)
                changed = True
            if changed and mark:
                self._dirty.add((key[0], key[2]))

    def pin_sig(self, key: LibraryKey, sig: CountsSig, *,
                mark: bool = True) -> None:
        """Mark ``sig`` as lockstep-unprovable: its lanes are evaluated
        straight through the exact serial path from now on (until a
        lockstep validation proves otherwise — see :meth:`map_sig`)."""
        with self._lock:
            e = self._entries.setdefault(key, _LibraryEntry())
            if sig not in e.pins:
                e.pins.add(sig)
                if mark:
                    self._dirty.add((key[0], key[2]))

    def mark_own(self, key: LibraryKey, sig: CountsSig) -> None:
        """Remember that ``sig`` diverged from a library order and went to
        the own-order seam, so the seam takes its lanes at once next time.
        Nothing proves the signature unreplayable, so it is not a pin: the
        routing without the seam ignores the mark and :meth:`export` leaves
        it out."""
        with self._lock:
            self._entries.setdefault(key, _LibraryEntry()).own.add(sig)

    def own_sigs(self, key: LibraryKey) -> Set[CountsSig]:
        """Snapshot of the signatures :meth:`mark_own` marked."""
        with self._lock:
            e = self._entries.get(key)
            return set() if e is None else set(e.own)

    def drop_graph(self, graph_hash: str) -> None:
        """Forget every entry (and pending write-back) of one graph — the
        worker registry calls this when it evicts the graph itself, so the
        worker-persistent library stays bounded alongside it."""
        with self._lock:
            for key in [k for k in self._entries if k[0] == graph_hash]:
                del self._entries[key]
            self._dirty = {d for d in self._dirty if d[0] != graph_hash}

    def __len__(self) -> int:
        with self._lock:
            return sum(len(e.orders) for e in self._entries.values())

    def counts(self) -> Dict[str, int]:
        """One consistent telemetry snapshot — distinct graphs, library
        keys, total orders, pending dirty flushes — for health surfaces
        (the sweep server's ``/healthz``).  Every public method takes the
        same internal lock, so a library shared across server request
        threads needs no external synchronisation."""
        with self._lock:
            return {
                "graphs": len({k[0] for k in self._entries}),
                "keys": len(self._entries),
                "orders": sum(len(e.orders)
                              for e in self._entries.values()),
                "dirty": len(self._dirty),
            }

    # ----------------------------------------------------- wire payloads
    def export(self, graph_hash: str, policy: str) -> Dict[Tuple, Dict]:
        """Picklable ``{template: {"orders": [...], "sigs": {...}}}`` for
        one (graph, policy) — the worker-registry / disk-store payload."""
        out: Dict[Tuple, Dict] = {}
        with self._lock:
            for (gh, template, pol), e in self._entries.items():
                if gh == graph_hash and pol == policy \
                        and (e.orders or e.pins):
                    out[template] = {
                        "orders": [list(o) for o in e.orders],
                        "sigs": {tuple(s): int(i) for s, i in e.sigs.items()},
                        "pins": [tuple(s) for s in sorted(e.pins)],
                    }
        return out

    def merge(self, fg: FrozenGraph, policy: str,
              payload: Mapping, mark_dirty: bool = True) -> int:
        """Fold an :meth:`export` payload in, validating every order
        against ``fg`` (:func:`order_valid`) and every signature mapping
        against the merged order list; returns the number of new orders
        accepted.  Malformed payloads contribute nothing — a corrupted
        disk entry or a garbled worker reply degrades to rediscovery.
        ``mark_dirty=False`` (loading *from* the store) applies the
        changes without scheduling a write-back; dirty marks set
        concurrently by other threads are never touched either way."""
        gh = fg.content_hash()
        added = 0
        try:
            items = list(payload.items())
        except AttributeError:
            return 0
        for template, entry in items:
            try:
                names, kind_pool = template
                key = (gh, (tuple(names), tuple(int(k) for k in kind_pool)),
                       policy)
                orders = list(entry["orders"])
                sigs = dict(entry.get("sigs", {}))
            except (TypeError, ValueError, KeyError):
                continue
            positions: Dict[int, int] = {}      # payload idx -> merged idx
            for i, order in enumerate(orders):
                with self._lock:
                    e = self._entries.get(key)
                    known = e.index.get(tuple(int(r) for r in order)) \
                        if e is not None else None
                if known is None and not order_valid(fg, order):
                    continue
                pos = self.record(key, order, mark=mark_dirty)
                if pos is None:
                    continue
                positions[i] = pos
                if known is None:
                    added += 1
            for sig, idx in sigs.items():
                try:
                    sig_t = tuple(int(c) for c in sig)
                    pos = positions.get(int(idx))
                except (TypeError, ValueError):
                    continue
                if pos is not None:
                    # a merged mapping is hearsay, not this process's own
                    # lockstep validation — it must not lift a pin
                    self.map_sig(key, sig_t, pos, validated=False,
                                 mark=mark_dirty)
            for sig in entry.get("pins", ()):
                try:
                    self.pin_sig(key, tuple(int(c) for c in sig),
                                 mark=mark_dirty)
                except (TypeError, ValueError):
                    continue
        return added

    def stage(self, graph_hash: str, policy: str, payload: Mapping) -> None:
        """Hold an :meth:`export` payload (possibly written by another
        process or package) for a graph that is not built yet; it is
        validated and merged by :meth:`merge_staged` once the graph is."""
        with self._lock:
            self._staged[(graph_hash, policy)] = payload

    def merge_staged(self, fg: FrozenGraph, policy: str) -> int:
        """:meth:`merge` the payload staged for ``fg`` (if any); returns
        the number of new orders accepted."""
        with self._lock:
            payload = self._staged.pop((fg.content_hash(), policy), None)
        return 0 if payload is None else self.merge(fg, policy, payload)

    def take_dirty(self, policy: str) -> List[str]:
        """Graph hashes with changes under ``policy`` since the last call
        (the Explorer's flush-to-disk worklist)."""
        with self._lock:
            taken = [gh for gh, pol in self._dirty if pol == policy]
            self._dirty -= {(gh, policy) for gh in taken}
            return taken


# ---------------------------------------------------------------------------
# The grouping / replay / rescue protocol
# ---------------------------------------------------------------------------


def simulate_grouped(fg: FrozenGraph, systems: Sequence[SystemConfig],
                     policy: str, *, min_lockstep: int = MIN_LOCKSTEP,
                     stats: Optional[BatchStats] = None,
                     library: Optional[ReplayLibrary] = None,
                     max_rounds: int = MAX_RESCUE_ROUNDS,
                     rescue_min: int = RESCUE_MIN,
                     schedule_free: bool = True,
                     prune: Optional[PruneContext] = None,
                     lockstep_fn: LockstepFn,
                     own_order_fn: Optional[LockstepFn] = None
                     ) -> List[Union[SimResult, Retired]]:
    """Schedule-free :class:`SimResult` per system, in input order.

    The shared outer loop of every candidate-axis engine: group systems by
    pool template, run small groups through per-candidate
    ``simulate_fast``, and hand each large group to ``lockstep_fn`` via
    :func:`replay_group` (library-routed replay + rescue + fallback).
    ``library`` carries discovered orders across calls, engines, processes
    and runs; ``None`` still rescues within the call via an ephemeral one.
    With a :class:`PruneContext` (``prune``), lockstep lanes may be
    retired mid-sweep and come back as :class:`Retired` markers instead of
    results; without one this never happens.

    ``own_order_fn`` is a backend's own-order seam (module docstring):
    small groups step their own orders through it, and so does every lane
    :func:`replay_group` would send to the exact path without a
    discovery.  It is not used with ``prune`` (retirement keeps the
    routing above) or when schedules are asked for.
    """
    if policy not in ("availability", "eft"):
        raise ValueError(f"unknown policy {policy!r}")
    own_fn = own_order_fn if prune is None and schedule_free else None
    results: List[Optional[Union[SimResult, Retired]]] = \
        [None] * len(systems)
    groups: Dict[Tuple, List[int]] = {}
    layouts: List[Layout] = []
    for i, system in enumerate(systems):
        names, counts, kind_pool = pool_layout(fg.kinds, system)
        layouts.append((names, counts, kind_pool))
        groups.setdefault((tuple(names), tuple(kind_pool)), []).append(i)

    with_schedule = not schedule_free
    for lanes in groups.values():
        if stats is not None:
            stats.groups += 1
        if len(lanes) < min_lockstep:
            if own_fn is not None:
                _own_order(fg, systems, layouts, lanes, policy, stats,
                           own_fn, results)
                continue
            for i in lanes:
                res, sp = _exact(fg, systems[i], policy, prune, i,
                                 with_schedule=with_schedule)
                _note(stats, sp, "small_group")
                results[i] = res
                if isinstance(res, Retired):
                    if stats is not None:
                        stats.retired_lanes += 1
                elif prune is not None:
                    prune.offer(systems[i].name, res.makespan)
            continue
        for i, sim in zip(lanes, replay_group(
                fg, [systems[i] for i in lanes],
                [layouts[i] for i in lanes], policy, stats, lockstep_fn,
                library=library, min_lockstep=min_lockstep,
                max_rounds=max_rounds, rescue_min=rescue_min,
                schedule_free=schedule_free,
                prune=prune.subset(lanes) if prune is not None else None,
                own_order_fn=own_fn)):
            results[i] = sim
    return results  # type: ignore[return-value]


def replay_group(fg: FrozenGraph, systems: Sequence[SystemConfig],
                 layouts: Sequence[Layout], policy: str,
                 stats: Optional[BatchStats],
                 lockstep_fn: LockstepFn, *,
                 library: Optional[ReplayLibrary] = None,
                 min_lockstep: int = MIN_LOCKSTEP,
                 max_rounds: int = MAX_RESCUE_ROUNDS,
                 rescue_min: int = RESCUE_MIN,
                 schedule_free: bool = True,
                 prune: Optional[PruneContext] = None,
                 own_order_fn: Optional[LockstepFn] = None
                 ) -> List[Union[SimResult, Retired]]:
    """One pool-template group through the multi-order replay protocol.

    Three phases, every completion either a validated lockstep lane or an
    exact serial run (so the exactness tiers are preserved by construction):

    1. **Signature routing** — lanes whose slot-count signature is in the
       library's map go straight to their remembered order: one lockstep
       sweep per routed order (cohorts below ``min_lockstep`` take the
       exact serial path instead — ``order_pinned_lanes``).
    2. **Cached-order trials** — the remaining cohort replays the library's
       untried orders in insertion order (the original reference first),
       while the cohort stays lockstep-worthy and each trial keeps
       passing lanes; a zero-pass trial stops the phase.
    3. **Discovery and rescue** — the most-parallel remaining lane is run
       serially with ``order_out=`` (recording its order and signature —
       the classic reference run is just this phase's first iteration),
       then the diverged cohort is re-batched in lockstep against the new
       order while the cohort is at least ``rescue_min`` wide and re-batches
       keep rescuing lanes.  At most ``max_rounds`` discoveries; past the
       budget (or a full library key) lanes degrade to plain serial
       fallbacks with nothing recorded.

    The reference/discovery lanes honor ``schedule_free`` (default: no
    :class:`~repro_torch.core.simulator.ScheduledTask` records are built —
    sweeps rank schedule-free and replay full records only for top-k
    winners); lockstep lanes are schedule-free by construction.

    With a :class:`PruneContext`, every completion (lockstep or serial)
    is offered to the live incumbent, each sweep re-reads the cutoff at
    launch, and lanes the backend retires come back as :class:`Retired`
    markers — never rescued, never signature-mapped (their replay was
    only validated through the retirement step, not end-to-end).  When
    the incumbent still needs completions to go finite (a cold top-k
    sweep), a phase-0 seeding pass runs that many of the most-parallel
    lanes — the likeliest winners — through the exact serial path first,
    recording their orders, so the main sweep starts with a live cutoff.

    With the own-order seam ``own_order_fn`` (never with ``prune``:
    :func:`simulate_grouped` passes it only without), every lane the
    phases above would send to the exact path without a discovery —
    pinned, in a thin routed cohort, or a serial fallback once the
    rounds are spent or the library key is full — steps its own order
    through the seam, in one call at the end.
    """
    lib = library if library is not None else ReplayLibrary()
    key = lib.key(fg, layouts[0], policy)
    orders, sig_map, pins = lib.lookup(key)
    n_cached = len(orders)
    # positions index the library entry; a dict (not the snapshot list)
    # because a concurrently shared library may assign a discovery a
    # position past the end of this call's snapshot
    order_by_pos: Dict[int, Tuple[int, ...]] = dict(enumerate(orders))
    sig_of = [tuple(lay[1]) for lay in layouts]
    totals = [sum(lay[1]) for lay in layouts]
    results: List[Optional[SimResult]] = [None] * len(systems)
    ever_diverged: Set[int] = set()
    failed_at: Dict[int, Set[int]] = {}     # lane -> positions it diverged on
    with_schedule = not schedule_free
    own: List[int] = []                     # lanes for the own-order seam

    def offer(i: int) -> None:
        if prune is not None:
            prune.offer(systems[i].name, results[i].makespan)

    def pinned_serial(i: int, hit: bool) -> None:
        if own_order_fn is not None:
            own.append(i)
            return
        res, sp = _exact(fg, systems[i], policy, prune, i,
                         with_schedule=with_schedule)
        results[i] = res
        if isinstance(res, Retired):
            if stats is not None:
                stats.retired_lanes += 1
            return
        offer(i)
        _note(stats, sp, "pinned")
        if stats is not None and hit:
            stats.order_hits += 1

    def sweep(lanes: List[int], position: int,
              from_cache: bool) -> List[int]:
        """Replay the order at ``position`` for ``lanes``; returns the
        lanes that diverged (their lockstep state is discarded).  Lanes
        the backend retired (partial bound past the cutoff) are finalised
        as :class:`Retired` markers here: provably outside the incumbent
        top-k, never rescued, never signature-mapped."""
        cuts = prune.cutoffs(lanes) if prune is not None else None
        done, diverged, retired = lockstep_fn(
            fg, order_by_pos[position], [layouts[i] for i in lanes],
            policy, cuts)
        for pos, sim in done.items():
            i = lanes[pos]
            results[i] = dataclasses.replace(sim, system=systems[i].name)
            lib.map_sig(key, sig_of[i], position)
            offer(i)
            if stats is not None:
                stats.lockstep_lanes += 1
                if from_cache:
                    stats.order_hits += 1
                if i in ever_diverged:
                    stats.rescued_lanes += 1
        for pos, bound in retired.items():
            results[lanes[pos]] = Retired(float(bound))
        if stats is not None and retired:
            stats.retired_lanes += len(retired)
            stats.retire_sweeps += 1
        failed = [lanes[pos] for pos in diverged]
        for i in failed:
            failed_at.setdefault(i, set()).add(position)
        if stats is not None:
            for i in failed:
                if i not in ever_diverged:
                    stats.diverged_lanes += 1
        ever_diverged.update(failed)
        return failed

    def fallback(lanes: List[int]) -> None:
        """``lanes`` on the exact path, nothing recorded."""
        for i in lanes:
            res, sp = _exact(fg, systems[i], policy, prune, i,
                             with_schedule=with_schedule)
            results[i] = res
            if isinstance(res, Retired):
                if stats is not None:
                    stats.retired_lanes += 1
                continue
            offer(i)
            _note(stats, sp, "fallback")

    # ---- phase 0: incumbent seeding (prune mode) ----------------------
    pending = list(range(len(systems)))
    if prune is not None:
        need = prune.deficit()
        if need:
            # branch-and-bound needs a finite incumbent before any bound
            # can cut: run the most-parallel lanes (the likeliest winners)
            # through the exact serial path first, recording their orders
            # so the rest of the group still routes
            seeds = sorted(pending, key=lambda j: (-totals[j], j))[:need]
            for i in seeds:
                out0: List[int] = []
                # the incumbent is still infinite here, but static energy
                # caps can already retire a seed (budgeted mode)
                res, sp = _exact(fg, systems[i], policy, prune, i,
                                 with_schedule=with_schedule,
                                 order_out=out0)
                results[i] = res
                if isinstance(res, Retired):
                    if stats is not None:
                        stats.retired_lanes += 1
                    continue
                offer(i)
                pos = lib.record(key, out0, sig_of[i])
                if pos is not None:
                    order_by_pos[pos] = tuple(out0)
                _note(stats, sp, "fallback" if pos is None else "discover")
            taken = set(seeds)
            pending = [i for i in pending if i not in taken]

    # ---- phase 1: signature routing ----------------------------------
    if sig_map or pins:
        routed: Dict[int, List[int]] = {}
        unrouted: List[int] = []
        for i in pending:
            if sig_of[i] in pins:
                # the library learned this signature's own heap order is
                # not lockstep-provable (the monotonicity check is
                # conservative) — straight to the exact serial path
                pinned_serial(i, hit=True)
                continue
            pos = sig_map.get(sig_of[i])
            if pos is not None and 0 <= pos < n_cached:
                routed.setdefault(pos, []).append(i)
            else:
                unrouted.append(i)
        pending = unrouted
        for pos in sorted(routed):
            lanes = routed[pos]
            if len(lanes) >= min_lockstep:
                for i in sweep(lanes, pos, from_cache=True):
                    # the map promised this order and validation said no:
                    # never lockstep-route the signature again
                    lib.pin_sig(key, sig_of[i])
                    pending.append(i)
            else:
                # replaying a thin cohort in lockstep costs more than the
                # serial loop: the library's win here is routing the lanes
                # *around* a doomed sweep, straight to the exact path
                for i in lanes:
                    pinned_serial(i, hit=True)

    # ---- phase 2: cached-order trials for the unrouted cohort ---------
    trial = 0
    while pending and trial < n_cached and len(pending) >= min_lockstep:
        # never re-replay a position a lane already diverged on (e.g. the
        # order its signature routed it to in phase 1): the engines are
        # deterministic, so the lane would diverge identically again
        cohort = [i for i in pending if trial not in failed_at.get(i, ())]
        if len(cohort) < min_lockstep:
            trial += 1
            continue
        failed = sweep(cohort, trial, from_cache=True)
        trial += 1
        if len(failed) == len(cohort):  # unproductive: stop trying
            break
        completed = set(cohort) - set(failed)
        pending = [i for i in pending if i not in completed]

    # ---- phase 3: discovery + bounded lockstep rescue -----------------
    rounds = 0
    rebatch_ok = True
    while pending:
        if rounds >= max_rounds:
            if own_order_fn is None:
                fallback(pending)
            break                       # with the seam: own orders, below
        i = max(pending, key=lambda j: (totals[j], j))
        pending.remove(i)
        out: List[int] = []
        res, sp = _exact(fg, systems[i], policy, prune, i,
                         with_schedule=with_schedule, order_out=out)
        results[i] = res
        rounds += 1
        if isinstance(res, Retired):
            # a retired discovery records nothing (its order is partial);
            # the next round picks another lane to discover with
            if stats is not None:
                stats.retired_lanes += 1
            continue
        offer(i)
        position = lib.record(key, out, sig_of[i])
        if position is not None and position in failed_at.get(i, ()):
            # the lane's own recorded order already failed its validation:
            # provably a conservative false positive — pin the signature so
            # warm sweeps go straight to serial instead of re-diverging
            lib.pin_sig(key, sig_of[i])
        _note(stats, sp, "fallback" if position is None else "discover")
        if position is None:
            if own_order_fn is None:
                fallback(pending)
            break
        order_by_pos[position] = tuple(out)
        # the first discovery's re-batch is the classic reference sweep;
        # later ones only pay off on wide cohorts that share orders, so
        # they are gated on width and stopped once a re-batch rescues
        # nothing (all-unique-order cohorts are discovered serially, which
        # costs the same as the old fallback but leaves the library warm)
        gate = min_lockstep if rounds == 1 else max(min_lockstep, rescue_min)
        if pending and rebatch_ok and len(pending) >= gate:
            before = len(pending)
            pending = sweep(pending, position, from_cache=False)
            if len(pending) == before and rounds > 1:
                rebatch_ok = False
    if own_order_fn is not None:
        _own_order(fg, systems, layouts, own + pending, policy, stats,
                   own_order_fn, results)
    return results  # type: ignore[return-value]


def simulate_many(items: Sequence[Tuple[FrozenGraph,
                                        Sequence[SystemConfig]]],
                  policy: str, *, lockstep_many_fn: LockstepManyFn,
                  min_lockstep: int = MIN_LOCKSTEP,
                  stats: Optional[BatchStats] = None,
                  library: Optional[ReplayLibrary] = None,
                  max_rounds: int = MAX_RESCUE_ROUNDS,
                  schedule_free: bool = True,
                  prunes: Optional[Sequence[Optional[PruneContext]]] = None,
                  own_order_fn: Optional[LockstepManyFn] = None
                  ) -> List[List[Union[SimResult, Retired]]]:
    """Every ``(graph, systems)`` family of a sweep through **one** backend
    call — the megabatch form of :func:`simulate_grouped`.

    :func:`simulate_grouped` hands each pool-template group of each graph
    to its own ``lockstep_fn`` call, so a sweep over many graphs pays one
    compiled sweep (and its remainder chunks) per group.  This protocol
    instead *plans* every group of every family up front — the same
    library routing as :func:`replay_group` phase 1, with the cheapest
    possible phase-2/3 stand-ins — and dispatches all resulting
    ``(fg, order, lanes)`` cohorts in a single ``lockstep_many_fn`` call,
    letting a megabatch-capable backend (``torchsim._scan_cohorts``) pad the
    cohorts together and share one compiled scan across the whole sweep.

    Protocol differences vs the per-group path, by design:

    * Groups with no cached orders run **one** serial reference discovery
      (their most-parallel lane, order recorded) and route the rest of the
      group to that fresh order *within the same megabatch* — phase 3's
      first re-batch, folded into the main sweep.
    * Unrouted lanes with cached orders try position 0 only (phase 2's
      first trial); there is **no rescue re-batching** — a diverged lane
      is discovered serially (order + signature recorded, bounded by
      ``max_rounds`` per group) or falls back serially.  The library still
      ends the call warm, so the *next* sweep routes those lanes straight
      to their own orders; ``rescued_lanes`` is therefore never counted
      here.

    Every completion is still either a validated lockstep lane or an exact
    serial run, so the engine tiers are preserved by construction.
    Returns one result list per family, each in its ``systems`` order.

    ``prunes`` carries one optional :class:`PruneContext` per family
    (sharing a live :class:`Incumbent` across them); cohorts then ship
    per-lane cutoffs into the megabatch dispatch, and retired lanes come
    back as :class:`Retired` markers exactly as in :func:`replay_group`.

    ``own_order_fn`` is a megabatch backend's own-order seam (module
    docstring), which takes the replayed cohorts too: with it, the one
    dispatch goes through it and carries, beside the replayed cohorts,
    one own-order cohort per group, where every lane goes that the plan
    above would send to the exact path without a replay — small groups,
    pinned signatures, cohorts under ``min_lockstep``, serial fallbacks —
    and a cold group's lanes after its one discovery (which seeds the
    library), instead of riding the fresh order.  Unrouted lanes of a
    group whose key holds orders still try the first one, unless the seam
    took their signature before (:meth:`ReplayLibrary.mark_own`); of those
    that diverge, the group discovers one (its most parallel) on the exact
    path, which records a second order, and marks the rest for the seam,
    which steps their own orders in a second dispatch.  The marks are no
    pins: the routing without the seam and :meth:`ReplayLibrary.export`
    ignore them, so a later ``batch`` sweep on the same library or disk
    cache routes as if no torch sweep had marked anything.  So a group
    makes at most one
    discovery a call: a call from an empty library runs no lane on the
    exact path but each group's first discovery, the next one each
    diverging group's, and one whose library knows every signature none.
    The seam is not used when any family is pruned (retirement keeps the
    routing above) or when schedules are asked for.
    """
    if policy not in ("availability", "eft"):
        raise ValueError(f"unknown policy {policy!r}")
    lib = library if library is not None else ReplayLibrary()
    with_schedule = not schedule_free
    own_fn = own_order_fn if schedule_free and (
        prunes is None or all(p is None for p in prunes)) else None
    results: List[List[Optional[Union[SimResult, Retired]]]] = \
        [[None] * len(systems) for _fg, systems in items]

    def pr_of(gi: int) -> Optional[PruneContext]:
        return prunes[gi] if prunes is not None else None

    def serial(gi: int, i: int, out: Optional[List[int]] = None):
        """The lane's exact run and its span (:func:`_exact`)."""
        fg, systems = items[gi]
        pr = pr_of(gi)
        res, sp = _exact(fg, systems[i], policy, pr, i,
                         with_schedule=with_schedule, order_out=out)
        if isinstance(res, Retired):
            if stats is not None:
                stats.retired_lanes += 1
        elif pr is not None:
            pr.offer(systems[i].name, res.makespan)
        return res, sp

    # ---- plan: route every group's lanes to (order, cohort) ------------
    cohorts: List[Dict] = []
    groups: List[Dict] = []     # with the seam: each group's own lanes
    for gi, (fg, systems) in enumerate(items):
        layouts = [pool_layout(fg.kinds, s) for s in systems]
        fams: Dict[Tuple, List[int]] = {}
        for i, lay in enumerate(layouts):
            fams.setdefault((tuple(lay[0]), tuple(lay[2])), []).append(i)
        for lanes in fams.values():
            if stats is not None:
                stats.groups += 1
            key = lib.key(fg, layouts[lanes[0]], policy)
            grp = {"gi": gi, "fg": fg, "key": key, "layouts": layouts,
                   "n_cached": 0, "discoveries": 0, "own": [], "again": [],
                   "diverged": []}
            if own_fn is not None:
                groups.append(grp)
            if len(lanes) < min_lockstep:
                if own_fn is not None:
                    grp["own"].extend(lanes)
                    continue
                for i in lanes:
                    results[gi][i], sp = serial(gi, i)
                    _note(stats, sp, "small_group")
                continue
            pr = pr_of(gi)
            if pr is not None and pr.deficit():
                # phase-0 incumbent seeding, as in replay_group: the most-
                # parallel lanes run serially (orders recorded) so the
                # megabatch launches with a finite cutoff
                seeds = sorted(lanes, key=lambda i: (-sum(layouts[i][1]),
                                                     i))[:pr.deficit()]
                for i in seeds:
                    out0: List[int] = []
                    results[gi][i], sp = serial(gi, i, out0)
                    if isinstance(results[gi][i], Retired):
                        continue            # partial order: never recorded
                    pos0 = lib.record(key, out0, tuple(layouts[i][1]))
                    _note(stats, sp,
                          "fallback" if pos0 is None else "discover")
                taken = set(seeds)
                lanes = [i for i in lanes if i not in taken]
                if not lanes:
                    continue
            orders, sig_map, pins = lib.lookup(key)
            own_sigs = lib.own_sigs(key) if own_fn is not None else set()
            grp["n_cached"] = len(orders)
            order_by_pos: Dict[int, Tuple[int, ...]] = dict(enumerate(orders))
            routed: Dict[int, List[int]] = {}
            unrouted: List[int] = []
            for i in lanes:
                sig = tuple(layouts[i][1])
                if sig in pins and own_fn is not None:
                    grp["own"].append(i)
                    continue
                if sig in pins:
                    results[gi][i], sp = serial(gi, i)
                    if not isinstance(results[gi][i], Retired):
                        _note(stats, sp, "pinned")
                        if stats is not None:
                            stats.order_hits += 1
                    continue
                pos = sig_map.get(sig)
                if pos is not None and 0 <= pos < len(orders):
                    routed.setdefault(pos, []).append(i)
                elif sig in own_sigs:
                    grp["own"].append(i)
                else:
                    unrouted.append(i)
            if unrouted and not orders:
                # cold group: one serial reference discovery (the
                # most-parallel lane), everyone else rides its fresh order
                # in the megabatch — replay_group's reference sweep folded
                # into the main dispatch (with the seam: steps its own)
                if max_rounds <= 0 and own_fn is not None:
                    grp["own"].extend(unrouted)
                    unrouted = []
                elif max_rounds <= 0:
                    for i in unrouted:
                        results[gi][i], sp = serial(gi, i)
                        if not isinstance(results[gi][i], Retired):
                            _note(stats, sp, "fallback")
                    unrouted = []
                else:
                    j = max(unrouted,
                            key=lambda i: (sum(layouts[i][1]), i))
                    unrouted.remove(j)
                    out: List[int] = []
                    results[gi][j], sp = serial(gi, j, out)
                    grp["discoveries"] += 1
                    if isinstance(results[gi][j], Retired):
                        # the group's likeliest winner is already beaten:
                        # no order to ride — the rest go serial, where the
                        # same cutoff aborts them just as fast
                        pos = None
                    else:
                        pos = lib.record(key, out, tuple(layouts[j][1]))
                        _note(stats, sp,
                              "fallback" if pos is None else "discover")
                    if own_fn is not None:
                        # the rest step their own orders in the one
                        # dispatch, not gambling on the fresh one
                        grp["own"].extend(unrouted)
                    elif pos is None:       # key full (shared library)
                        for i in unrouted:
                            results[gi][i], sp = serial(gi, i)
                            if not isinstance(results[gi][i], Retired):
                                _note(stats, sp, "fallback")
                        unrouted = []
                    else:
                        order_by_pos[pos] = tuple(out)
                        routed.setdefault(pos, []).extend(unrouted)
                        unrouted = []
            elif unrouted:
                # untried signatures take the insertion-order first order
                # (the original reference), like phase 2's first trial
                routed.setdefault(0, []).extend(unrouted)
            for pos, cl in routed.items():
                if own_fn is not None and len(cl) < min_lockstep:
                    grp["own"].extend(cl)
                    continue
                cohorts.append({"grp": grp, "position": pos,
                                "order": order_by_pos[pos], "lanes": cl})

    # A megabatch below min_lockstep is a doomed sweep (the same economics
    # as replay_group's thin routed cohorts): route its lanes straight to
    # the exact serial path instead.  (With the seam every replayed
    # cohort has min_lockstep lanes.)
    if own_fn is None and cohorts \
            and sum(len(c["lanes"]) for c in cohorts) < min_lockstep:
        for c in cohorts:
            grp = c["grp"]
            gi = grp["gi"]
            for i in c["lanes"]:
                results[gi][i], sp = serial(gi, i)
                if not isinstance(results[gi][i], Retired):
                    _note(stats, sp, "pinned")
                    if stats is not None and \
                            c["position"] < grp["n_cached"]:
                        stats.order_hits += 1
        cohorts = []

    def discover(grp: Dict, i: int, position: int) -> None:
        """Lane ``i`` of ``grp``, which diverged from the order at
        ``position``, on the exact path with its order recorded."""
        gi, key = grp["gi"], grp["key"]
        sig = tuple(grp["layouts"][i][1])
        out: List[int] = []
        results[gi][i], sp = serial(gi, i, out)
        grp["discoveries"] += 1
        if isinstance(results[gi][i], Retired):
            return                          # partial order: never recorded
        pos = lib.record(key, out, sig)
        if pos is None:
            _note(stats, sp, "fallback")
            return
        if pos == position:
            # its own recorded order is the one it just failed: provably
            # a conservative false positive — pin it
            lib.pin_sig(key, sig)
        _note(stats, sp, "discover")

    def own_spec(grp: Dict, lanes: List[int]) -> CohortSpec:
        return (grp["fg"], None, [grp["layouts"][i] for i in lanes], None)

    def own_finish(grp: Dict, lanes: List[int], out) -> None:
        gi = grp["gi"]
        _own_results(out, lanes, items[gi][1], results[gi],
                     lambda i: serial(gi, i), stats)

    # ---- one megabatch dispatch for every cohort of every family -------
    owns = [g for g in groups if g["own"]]
    if cohorts or owns:
        outs = (own_fn or lockstep_many_fn)(
            [(c["grp"]["fg"], c["order"],
              [c["grp"]["layouts"][i] for i in c["lanes"]],
              None if pr_of(c["grp"]["gi"]) is None
              else pr_of(c["grp"]["gi"]).cutoffs(c["lanes"]))
             for c in cohorts] + [own_spec(g, g["own"]) for g in owns])
        for g, out in zip(owns, outs[len(cohorts):]):
            own_finish(g, g["own"], out)
        for c, (done, diverged, retired) in zip(cohorts, outs):
            grp = c["grp"]
            gi, key, layouts = grp["gi"], grp["key"], grp["layouts"]
            systems = items[gi][1]
            pr = pr_of(gi)
            from_cache = c["position"] < grp["n_cached"]
            for pos_l, bound in retired.items():
                results[gi][c["lanes"][pos_l]] = Retired(float(bound))
            if stats is not None and retired:
                stats.retired_lanes += len(retired)
                stats.retire_sweeps += 1
            for pos_l, sim in done.items():
                i = c["lanes"][pos_l]
                results[gi][i] = dataclasses.replace(
                    sim, system=systems[i].name)
                lib.map_sig(key, tuple(layouts[i][1]), c["position"])
                if pr is not None:
                    pr.offer(systems[i].name, sim.makespan)
                if stats is not None:
                    stats.lockstep_lanes += 1
                    if from_cache:
                        stats.order_hits += 1
            for pos_l in diverged:
                i = c["lanes"][pos_l]
                if stats is not None:
                    stats.diverged_lanes += 1
                if own_fn is not None:
                    grp["diverged"].append((i, c["position"]))
                elif grp["discoveries"] >= max_rounds:
                    results[gi][i], sp = serial(gi, i)
                    if not isinstance(results[gi][i], Retired):
                        _note(stats, sp, "fallback")
                else:
                    # serial discovery: the lane's own order is recorded
                    # so the next sweep routes it (no rescue re-batch)
                    discover(grp, i, c["position"])
    # ---- with the seam: one discovery for each group whose lanes
    # diverged (its most parallel such lane), the rest marked and in their
    # own orders in a second dispatch ------------------------------------
    for grp in groups:
        lanes_d = grp["diverged"]
        if not lanes_d:
            continue
        if grp["discoveries"] < max_rounds:
            j, position = max(lanes_d, key=lambda d: (
                sum(grp["layouts"][d[0]][1]), d[0]))
            discover(grp, j, position)
            lanes_d = [d for d in lanes_d if d[0] != j]
        for i, _ in lanes_d:
            lib.mark_own(grp["key"], tuple(grp["layouts"][i][1]))
            grp["again"].append(i)
    again = [g for g in groups if g["again"]]
    if again:
        outs = own_fn([own_spec(g, g["again"]) for g in again])
        for g, out in zip(again, outs):
            own_finish(g, g["again"], out)
    return results  # type: ignore[return-value]


def graph_aux(fg: FrozenGraph, ci, rank, asets):
    """Graph-only lockstep constants, memoised on the FrozenGraph (repeat
    sweeps — hillclimbs, re-ranks — hit the same frozen payload many
    times): the strictly-(creation_index, rank)-monotone tie-break scalar
    per row, and the dense conditional-activation mask for vectorised
    membership tests.  Dropped on pickling like ``_rt``.
    """
    aux = getattr(fg, "_batch_aux", None)
    if aux is None:
        n = fg.n
        tb = [ci[i] * n + rank[i] for i in range(n)]
        act_mask = np.zeros((n, len(fg.kinds)), dtype=bool)
        for i in range(n):
            for k in asets[i]:
                act_mask[i, k] = True
        aux = fg._batch_aux = (tb, act_mask)
    return aux


def lane_results(fg: FrozenGraph, pool_names: Sequence[str],
                 lane_counts: Sequence[Sequence[int]],
                 lanes: Sequence[int], policy: str,
                 makespan: np.ndarray, busy: np.ndarray, seen: np.ndarray,
                 placement: np.ndarray) -> Dict[int, SimResult]:
    """Assemble per-lane schedule-free results from stacked state.

    ``lanes[li]`` is the original lane position of local column ``li`` in
    the lane-last state arrays (``makespan [L]``, ``busy/seen [P, L]``,
    ``placement [n, L]``); ``lane_counts`` is indexed by *original*
    position.  ``system`` is left empty for the caller
    (:func:`replay_group`) to fill.
    """
    kinds = fg.kinds
    P = len(pool_names)
    comp_arr = np.flatnonzero(fg.is_compute)
    comp_uids = fg.uid[comp_arr].tolist()
    kinds_obj = np.asarray(kinds, dtype=object)
    comp_place = placement[comp_arr]                   # [C, L]
    done: Dict[int, SimResult] = {}
    for li, pos in enumerate(lanes):
        counts = lane_counts[pos]
        kp = comp_place[:, li]
        placed = kp >= 0
        if placed.all():
            placements = dict(zip(comp_uids, kinds_obj[kp].tolist()))
        else:
            placements = {u: kinds[k] for u, k, m
                          in zip(comp_uids, kp.tolist(), placed.tolist()) if m}
        done[pos] = SimResult(
            makespan=float(makespan[li]), schedule=[],
            busy={pool_names[p]: float(busy[p, li]) for p in range(P)
                  if seen[p, li]},
            pool_slots={pool_names[p]: counts[p] for p in range(P)},
            placements=placements, policy=policy, system="")
    return done


# ---------------------------------------------------------------------------
# Equivalence tiers
# ---------------------------------------------------------------------------


def makespans_close(a: float, b: float, tolerance: float) -> bool:
    """Tier test for one makespan pair: exact ``==`` at tolerance 0, else
    relative error ``|a - b| <= tolerance * max(|a|, |b|)``."""
    if tolerance == 0.0:
        return a == b
    return abs(a - b) <= tolerance * max(abs(a), abs(b))


def sims_equivalent(got: SimResult, ref: SimResult,
                    tolerance: float = 0.0) -> bool:
    """Whether ``got`` matches ``ref`` at the given engine tier.

    Tolerance 0 (the exact engines) demands float equality on makespan and
    every busy sum plus identical placements, pool layout and policy.  A
    non-zero tolerance (the torch tier) relaxes *only the floats* to relative
    error — placements and structure stay discrete and must match exactly.
    """
    if not (got.placements == ref.placements
            and got.pool_slots == ref.pool_slots
            and got.policy == ref.policy
            and set(got.busy) == set(ref.busy)):
        return False
    if not makespans_close(got.makespan, ref.makespan, tolerance):
        return False
    return all(makespans_close(got.busy[p], ref.busy[p], tolerance)
               for p in ref.busy)


def rankings_equivalent(got: Sequence[str], ref: Sequence[str],
                        ref_makespans: Mapping[str, float],
                        tolerance: float = 0.0) -> bool:
    """Ranking-stability test between two ranked name sequences.

    Both sequences must rank the same candidate set.  At tolerance 0 the
    orders must be identical.  At a non-zero tolerance, positions may
    disagree only where the *reference* makespans of the two swapped
    candidates are themselves within tolerance of each other — i.e. the
    documented tie-break: candidates whose makespans agree to within the
    tier are ties, and ties are broken deterministically by submission
    order (the stable sort both rankings use), so any residual disagreement
    between a sub-tolerance pair is a legal tie resolution and anything
    larger is a real ranking error.
    """
    if list(got) == list(ref):
        return True
    if tolerance == 0.0 or sorted(got) != sorted(ref):
        return False
    for a, b in zip(got, ref):
        if a != b and not makespans_close(ref_makespans[a], ref_makespans[b],
                                          tolerance):
            return False
    return True


def frontiers_equivalent(got: Sequence[str], ref: Sequence[str],
                         ref_objectives: Mapping[str, Mapping[str, float]],
                         axes: Sequence[str], tolerance: float = 0.0,
                         noisy: Sequence[str] = ("makespan_s",
                                                 "energy_j")) -> bool:
    """Frontier-stability test between two Pareto-frontier name sets.

    The multi-objective analogue of :func:`rankings_equivalent`: *which*
    candidates sit on the frontier is a set question, so order is
    ignored.  At tolerance 0 (the exact engines) the sets must be
    identical — the frontier is a deterministic function of bit-identical
    objective values.

    At a non-zero tolerance (the torch tier), only the ``noisy`` axes carry
    simulated floats (makespan, and energy = static·makespan + dynamic·
    busy); the remaining axes are spec arithmetic on the candidate's pool
    layout and engine-independent.  A perturbation of at most ``rtol`` on
    the noisy axes can change frontier membership only across sub-
    tolerance margins, which gives a checkable two-sided contract against
    the *reference* objective values:

    * a candidate ``x`` **dropped** from the reference frontier must have
      been overtaken: some candidate ``y`` must match-or-beat ``x`` on
      every exact axis and be within tolerance of (or beat) ``x`` on
      every noisy axis — otherwise no rtol-sized perturbation could have
      dominated ``x`` away;
    * a candidate ``x`` that **appeared** (reference says dominated) must
      have escaped each of its reference dominators across a noisy
      margin: every ``y`` that strictly dominates ``x`` in the reference
      must be within tolerance of ``x`` on at least one noisy axis —
      an exact-axis or super-tolerance domination cannot be perturbed
      away.

    Names unknown to ``ref_objectives`` fail the test outright.
    """
    got_set, ref_set = set(got), set(ref)
    if any(n not in ref_objectives for n in got_set | ref_set):
        return False
    if got_set == ref_set:
        return True
    if tolerance == 0.0:
        return False
    exact_axes = [a for a in axes if a not in noisy]
    noisy_axes = [a for a in axes if a in noisy]

    def covers(y: Mapping[str, float], x: Mapping[str, float]) -> bool:
        # y could plausibly dominate x once noisy axes wiggle by the tier
        return (all(y[a] <= x[a] for a in exact_axes)
                and all(y[a] <= x[a]
                        or makespans_close(y[a], x[a], tolerance)
                        for a in noisy_axes))

    for name in ref_set - got_set:          # dropped from the frontier
        x = ref_objectives[name]
        if not any(covers(ref_objectives[y], x)
                   for y in ref_objectives if y != name):
            return False
    for name in got_set - ref_set:          # appeared on the frontier
        x = ref_objectives[name]
        for y, yv in ref_objectives.items():
            if y == name:
                continue
            strict = (all(yv[a] <= x[a] for a in axes)
                      and any(yv[a] < x[a] for a in axes))
            if strict and not any(
                    makespans_close(yv[a], x[a], tolerance)
                    for a in noisy_axes):
                return False
    return True
