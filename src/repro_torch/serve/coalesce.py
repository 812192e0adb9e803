"""Cross-request candidate coalescing for the sweep service.

Concurrent sweep requests frequently ask about the *same application*:
the trace (hence the FrozenGraph) and the policy match, only the
candidate systems differ — and often not even those.  Each exact-engine
family evaluation is embarrassingly mergeable: ``simulate_batch`` lanes
are independent columns of one lockstep sweep, and a lane's result
depends only on ``(graph, policy, its own system)``, never on its
cohort.  So instead of N requests paying N lockstep sweeps over the same
graph, the :class:`Coalescer` merges their families into one batch:

* the **first** submitter of a ``(graph content hash, policy)`` key
  becomes the *leader* — it opens a batch, waits a short window for
  followers, then runs one ``simulate_batch`` over the union of lanes;
* **followers** that arrive inside the window merge their systems into
  the open batch and block on its completion event;
* duplicate lanes across requests (identical clients asking the exact
  same question — the common service workload) are **deduplicated** by
  pickled-system identity, so N identical requests cost one lane set;
* results fan back out by per-request lane index, so every request
  receives exactly the lanes it asked for — bit-identical to running
  alone, because lane results are cohort-independent and the exact tier
  admits no drift.

Deadlines stay per-request: a follower waits at most its own remaining
budget and raises :class:`concurrent.futures.TimeoutError` on expiry —
which the Explorer treats as a missed deadline (quarantine path), not an
engine fault, so one slow batch cannot demote a victim request's engine.
A batch *failure* is different: the leader broadcasts the exception and
every participant re-raises it, driving each request's own demotion
chain (and, service-side, the circuit breaker).

The coalescer is engine-scoped to ``batch`` on purpose: the torch tier is
rtol (cohort-size-dependent padding could legally wiggle floats across
merges, so a torch result is never merged or served as bit-identical)
and the reference/fast engines never batch families at all.
"""
from __future__ import annotations

import contextlib
import pickle
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.batchsim import simulate_batch
from ..core.fastsim import FrozenGraph
from ..core.replay import (BatchStats, MAX_RESCUE_ROUNDS, ReplayLibrary)
from ..core.simulator import SimResult

#: Default coalescing window: how long a leader holds a batch open for
#: followers.  Well under human latency tolerance, well over the lock
#: handoff time between server request threads.
DEFAULT_WINDOW_S = 0.02


class CoalesceStats:
    """Service-lifetime coalescing counters (lock-owned by the Coalescer).

    ``batches`` counts lockstep dispatches; ``solo_batches`` those with a
    single participant; ``requests`` family submissions; ``lanes`` total
    lanes submitted; ``coalesced_lanes`` lanes that rode a batch some
    *other* request led — the figure of merit for the whole module;
    ``dedup_lanes`` submitted lanes that were byte-identical to one
    already in the batch and so were never evaluated at all."""

    __slots__ = ("batches", "solo_batches", "requests", "lanes",
                 "coalesced_lanes", "dedup_lanes")

    def __init__(self) -> None:
        self.batches = 0
        self.solo_batches = 0
        self.requests = 0
        self.lanes = 0
        self.coalesced_lanes = 0
        self.dedup_lanes = 0

    def hit_rate(self) -> float:
        """Fraction of lanes that piggybacked on another request's batch."""
        return self.coalesced_lanes / self.lanes if self.lanes else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"batches": self.batches, "solo_batches": self.solo_batches,
                "requests": self.requests, "lanes": self.lanes,
                "coalesced_lanes": self.coalesced_lanes,
                "dedup_lanes": self.dedup_lanes,
                "hit_rate": round(self.hit_rate(), 6)}


class _Batch:
    """One open-or-running merged family evaluation."""

    __slots__ = ("fg", "policy", "systems", "_index", "participants",
                 "open", "done", "results", "error")

    def __init__(self, fg: FrozenGraph, policy: str):
        self.fg = fg
        self.policy = policy
        self.systems: List = []         # unique lanes, evaluation order
        self._index: Dict[bytes, int] = {}      # pickled system -> lane
        self.participants = 0
        self.open = True
        self.done = threading.Event()
        self.results: Optional[List[SimResult]] = None
        self.error: Optional[BaseException] = None

    def add(self, systems: Sequence) -> Tuple[List[int], int]:
        """Merge one request's lanes in; returns ``(positions, dups)``.

        Identical lanes across requests (byte-identical pickles — which
        identical request construction guarantees) collapse onto one
        evaluated lane whose result fans out to every owner: a lane's
        result depends only on (graph, policy, system), so sharing it is
        bit-exact.  A pickle mismatch between semantically equal systems
        merely costs the dedup, never correctness."""
        positions: List[int] = []
        dups = 0
        for s in systems:
            key = pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL)
            pos = self._index.get(key)
            if pos is None:
                pos = len(self.systems)
                self.systems.append(s)
                self._index[key] = pos
            else:
                dups += 1
            positions.append(pos)
        self.participants += 1
        return positions, dups


class _RequestTelemetry(threading.local):
    def __init__(self) -> None:
        self.active = False
        self.lanes = 0
        self.coalesced = 0
        self.dedup = 0
        self.batches = 0


class Coalescer:
    """Merge concurrent same-graph family evaluations into one batch.

    Plugs into :class:`~repro_torch.core.explore.Explorer` as its
    ``family_runner``; the service wraps each request's explore() in
    :meth:`context` to collect per-request telemetry.  ``library`` is the
    service-wide :class:`ReplayLibrary` so every batch (whoever leads it)
    reads and warms the same orders; per-batch :class:`BatchStats` fold
    into ``batch_stats`` under the coalescer lock.

    ``load_fn`` reports the number of requests currently in flight
    (the service's running counter) and bounds the window twice over: a
    solo request (load <= 1) skips the wait entirely — it must not pay
    the coalescing latency floor just in case company shows up — and a
    leader whose batch already holds every in-flight request closes
    *early*, because nobody else exists who could still join.  Without
    ``load_fn`` the full window is always paid (unit-test mode).
    """

    def __init__(self, window_s: float = DEFAULT_WINDOW_S, *,
                 library: Optional[ReplayLibrary] = None,
                 max_rounds: int = MAX_RESCUE_ROUNDS,
                 load_fn: Optional[Callable[[], int]] = None):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s!r}")
        self.window_s = float(window_s)
        self.library = library
        self.max_rounds = int(max_rounds)
        self.load_fn = load_fn
        self.stats = CoalesceStats()
        self.batch_stats = BatchStats()
        self._lock = threading.Lock()
        self._open: Dict[Tuple[str, str], _Batch] = {}
        self._tl = _RequestTelemetry()

    def replay_stats(self) -> Dict[str, int]:
        """Locked snapshot of the folded per-batch BatchStats — batch
        counters belong to the merged batch, not to any one request, so
        they surface service-wide (``/healthz``) rather than per-doc."""
        with self._lock:
            return self.batch_stats.as_dict()

    # -------------------------------------------------- per-request view
    @contextlib.contextmanager
    def context(self):
        """Collect this thread's lanes/coalesced/batches counters across
        one request; yields a dict filled in on exit."""
        tl = self._tl
        tl.active = True
        tl.lanes = tl.coalesced = tl.dedup = tl.batches = 0
        out: Dict[str, int] = {}
        try:
            yield out
        finally:
            out.update(lanes=tl.lanes, coalesced_lanes=tl.coalesced,
                       dedup_lanes=tl.dedup, batches=tl.batches)
            tl.active = False

    # ----------------------------------------------------------- running
    def run_family(self, fg: FrozenGraph, systems: Sequence,
                   policy: str,
                   deadline_left_s: Optional[float] = None
                   ) -> List[SimResult]:
        """One family evaluation through the merge protocol; the
        Explorer ``family_runner`` entry point (policy bound by the
        service per request).

        Returns one SimResult per system, in order, bit-identical to a
        solo ``simulate_batch`` call.  Raises FuturesTimeout when the
        request's remaining deadline expires before the batch completes;
        re-raises the batch's engine fault for every participant.
        """
        if deadline_left_s is not None and deadline_left_s <= 0:
            raise FuturesTimeout("sweep deadline expired before the "
                                 "family evaluation started")
        key = (fg.content_hash(), policy)
        with self._lock:
            self.stats.requests += 1
            self.stats.lanes += len(systems)
            if self._tl.active:
                self._tl.lanes += len(systems)
            b = self._open.get(key)
            leader = not (b is not None and b.open)
            if leader:
                b = _Batch(fg, policy)
                self._open[key] = b
            positions, dups = b.add(systems)
            self.stats.dedup_lanes += dups
            if self._tl.active:
                self._tl.dedup += dups
            if not leader:
                self.stats.coalesced_lanes += len(systems)
                if self._tl.active:
                    self._tl.coalesced += len(systems)

        if leader:
            self._lead(key, b, deadline_left_s)
        else:
            if self._tl.active:
                self._tl.batches += 1
            if not b.done.wait(timeout=deadline_left_s):
                # the batch outlived *this* request's budget; the leader
                # still completes it and other participants keep waiting
                raise FuturesTimeout(
                    f"coalesced batch missed this request's deadline "
                    f"({deadline_left_s:.3f}s left at submit)")
        if b.error is not None:
            raise RuntimeError(
                f"coalesced family evaluation failed: {b.error}"
            ) from b.error
        assert b.results is not None
        return [b.results[i] for i in positions]

    def _lead(self, key: Tuple[str, str], b: _Batch,
              deadline_left_s: Optional[float]) -> None:
        """Leader path: hold the window, close, evaluate, broadcast."""
        window = self.window_s
        if window > 0 and self.load_fn is not None \
                and int(self.load_fn()) <= 1:
            window = 0.0
        if deadline_left_s is not None:
            window = min(window, max(0.0, deadline_left_s))
        if window > 0 and self.load_fn is None:
            time.sleep(window)
        elif window > 0:
            # two early-close triggers, because the full window is a
            # worst-case bound, not a target:
            #  * saturation — every in-flight request has joined this
            #    batch, so nobody is left to wait for;
            #  * quiescence — no new participant for a grace period
            #    means the arrival convoy has passed (the load count
            #    can overstate joinable requests: a client between
            #    requests, or one working a different graph, is
            #    "running" but will never join this batch).
            grace = max(0.002, window / 5.0)
            now = time.perf_counter()
            end = now + window
            joined, last_join = 1, now
            while True:
                with self._lock:
                    if b.participants > joined:
                        joined, last_join = b.participants, now
                now = time.perf_counter()
                if (now >= end or joined >= int(self.load_fn())
                        or now - last_join >= grace):
                    break
                time.sleep(min(0.001, end - now))
        with self._lock:
            b.open = False
            if self._open.get(key) is b:
                del self._open[key]
            n_parts = b.participants
            self.stats.batches += 1
            if n_parts == 1:
                self.stats.solo_batches += 1
            if self._tl.active:
                self._tl.batches += 1
        local = BatchStats()
        try:
            b.results = simulate_batch(
                b.fg, b.systems, b.policy, stats=local,
                library=self.library, max_rounds=self.max_rounds)
        except BaseException as exc:    # noqa: BLE001 — broadcast to all
            b.error = exc
            raise RuntimeError(
                f"coalesced family evaluation failed: {exc}") from exc
        finally:
            with self._lock:
                self.batch_stats.add_dict(local.as_dict())
            b.done.set()