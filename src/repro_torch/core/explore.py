"""Design-space exploration engine — the paper's §VI loop, industrialised.

The seed ``explore()`` was a serial for-loop: build one augmented task graph
per candidate, simulate, rank.  At co-design scale ("more
scenarios, faster") the loop shape matters more than any single estimate:
CEDR-style sweeps run thousands of scheduler×accelerator points and
hardware-HEFT ranks whole candidate batches.  This module turns the loop
into a subsystem:

* **Candidate generators** — :class:`DesignSpace` enumerates grid points,
  random samples, and hill-climb neighbourhoods over named design axes
  (block size, #accelerator slots, ±SMP, overlap mode...).  One generator
  API serves the Zynq fabric sweep, the pod-level step-task sweep and the
  ``benchmarks/hillclimb.py`` searches.
* **Memoization** — augmentation dominates repeat cost, and candidates that
  differ only in *slot counts* (1acc vs 2acc) share the same augmented
  graph.  :class:`Explorer` caches graphs per (eligibility × cost-relevant
  system knobs) and whole simulations per (graph × pool layout × policy),
  with hit/miss counters (:class:`CacheStats`).  With ``cache_dir`` set,
  both layers persist to an on-disk content-addressed store keyed by trace
  fingerprint + eligibility/system signature, so *repeated sweeps across
  processes and runs* skip straight to re-ranking.
* **Compiled evaluation** — ``engine=`` selects among the four engines
  (:data:`ENGINE_NAMES`): the reference object engine, the per-candidate
  array engine, the candidate-axis numpy lockstep (default — all
  slot-count variants of one picklable :class:`FrozenGraph` advance in a
  single sweep, schedule-free, ranking-identical to per-candidate
  :func:`~repro_torch.core.fastsim.simulate_fast`), and the torch step
  loop on the card (:mod:`repro_torch.core.torchsim`, rtol tier — the
  default).  Full
  :class:`ScheduledTask` records are materialised only for the top-k
  winners.  The legacy ``fast``/``batch`` booleans keep working.
* **Parallel evaluation** — ``processes=N`` fans graph×candidate-slice
  chunks out to a ``ProcessPoolExecutor`` whose workers keep a persistent
  content-hash→FrozenGraph registry (seeded once per worker from the first
  payload-bearing chunk, or straight from the on-disk store), so repeat
  chunks ship a 64-char hash instead of re-pickling the graph;
  ``max_workers`` keeps the legacy thread pool for evaluators that do
  native work.  Either way submission is chunked and results are ordered
  by submission index, so any worker count produces bit-identical tables.
* **Early pruning** — fabric-infeasible candidates are rejected before any
  graph is built (the paper's "2×128 mxm does not fit" check), and an
  optional lower-bound cut skips simulating candidates whose critical path
  already exceeds the current best: the bound is exact (conditional DMA
  tasks are zero-costed), so the true optimum is never discarded.
* **Structured results** — :class:`ExplorationResult` v2 records one
  :class:`CandidateOutcome` per candidate (status, makespan, lower bound,
  per-candidate analysis time, cache provenance), a ranked top-k table, and
  JSON round-trip serialisation for storing sweeps as artifacts.
* **Multi-objective PPA ranking** — ``Explorer(objectives=, budgets=)``
  annotates every simulated candidate with area/peak-power/energy from a
  :class:`~repro_torch.core.hwspec.SpecLibrary` (derived from the sweep's own
  kernel reports unless one is passed in), rejects budget violations as
  ``infeasible`` (area/power before any graph is built; energy after the
  sim, plus an exact ``static_w × lower_bound`` pre-cut), and exposes the
  Pareto frontier on :class:`ExplorationResult` as a first-class
  alternative to scalar top-k.  See docs/architecture.md
  "Multi-objective ranking".

``explore()`` keeps the seed signature as a thin front-end.
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import itertools
import json
import multiprocessing
import os
import random
import sys
import threading
import time
import uuid
import warnings
from concurrent.futures import (CancelledError, ProcessPoolExecutor,
                                ThreadPoolExecutor)
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures.process import BrokenProcessPool
from typing import (Any, Callable, Dict, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

from .augment import (Eligibility, TraceAnalysis, build_graph,
                      lower_bound_cost)
from .batchsim import BatchStats, simulate_batch
from .devices import SystemConfig
from .diskcache import DiskCache, sha256_text, trace_fingerprint
from .estimator import PerfEstimate
from .fastsim import FrozenGraph, simulate_fast
from .hwspec import (Budgets, OBJECTIVE_NAMES, SpecLibrary,
                     normalize_objectives, pareto_indices)
from .replay import (ENGINE_FALLBACK, ENGINE_TOLERANCE, Incumbent,
                     MAX_RESCUE_ROUNDS, PruneContext, ReplayLibrary, Retired)
from .hlsreport import KernelReport, ReportMap, ZYNQ_7045_BUDGET, fits
from .simulator import SimResult, simulate
from .taskgraph import TaskGraph
from .trace import Trace
from .. import DeviceError, tracing
from ..testing import faults

# --- fault-tolerance bounds (see docs/architecture.md "Failure model") ---
#: Re-submissions of a lost chunk after worker death before the chunk is
#: broken apart and its candidates isolated in-parent.
MAX_CHUNK_RETRIES = 2
#: Capped exponential backoff between process-pool respawns: the n-th
#: respawn of one explore call sleeps ``min(CAP, BASE * 2**(n-1))``.
BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 1.0


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Candidate:
    """One hardware/software co-design point."""

    name: str
    system: SystemConfig
    eligibility: Eligibility
    # (report, count) pairs describing what is instantiated in the fabric —
    # used for the feasibility check before any graph is built.
    fabric: Sequence[Tuple[KernelReport, int]] = ()

    def feasible(self, budget: Mapping[str, float] = ZYNQ_7045_BUDGET) -> bool:
        return fits(list(self.fabric), budget)


# ---------------------------------------------------------------------------
# Candidate generators: grid / random / hill-climb neighbourhoods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named design dimension and its discrete, ordered values."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self) -> None:
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")


class DesignSpace:
    """Cartesian product of :class:`Axis` — the candidate generator.

    Construct from a mapping (ordered) or a sequence of axes::

        space = DesignSpace({"n_acc": (1, 2, 3), "smp": (False, True)})
        for point in space.points(): ...          # grid, deterministic order
        space.sample(8, seed=0)                   # distinct random points
        space.neighbors({"n_acc": 2, "smp": False})   # ±1 step per axis
    """

    def __init__(self, axes: Mapping[str, Sequence[Any]] | Sequence[Axis]):
        if isinstance(axes, Mapping):
            self.axes: Tuple[Axis, ...] = tuple(
                Axis(k, tuple(v)) for k, v in axes.items())
        else:
            self.axes = tuple(axes)
        if not self.axes:
            raise ValueError("empty design space")
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names: {names}")

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= len(a.values)
        return n

    def points(self) -> Iterator[Dict[str, Any]]:
        """Full grid in row-major axis order (deterministic)."""
        for combo in itertools.product(*(a.values for a in self.axes)):
            yield {a.name: v for a, v in zip(self.axes, combo)}

    def point_at(self, flat_index: int) -> Dict[str, Any]:
        if not 0 <= flat_index < self.size:
            raise IndexError(flat_index)
        out: Dict[str, Any] = {}
        for a in reversed(self.axes):
            flat_index, i = divmod(flat_index, len(a.values))
            out[a.name] = a.values[i]
        return {a.name: out[a.name] for a in self.axes}

    def sample(self, n: int, seed: int = 0) -> List[Dict[str, Any]]:
        """``n`` distinct grid points, deterministic in ``seed``."""
        n = min(n, self.size)
        rng = random.Random(seed)
        idx = rng.sample(range(self.size), n)
        return [self.point_at(i) for i in idx]

    def neighbors(self, point: Mapping[str, Any]) -> List[Dict[str, Any]]:
        """All points one value-step away along a single axis."""
        out: List[Dict[str, Any]] = []
        for a in self.axes:
            i = a.values.index(point[a.name])
            for j in (i - 1, i + 1):
                if 0 <= j < len(a.values):
                    nb = dict(point)
                    nb[a.name] = a.values[j]
                    out.append(nb)
        return out


def hillclimb(space: DesignSpace, score: Callable[[Mapping[str, Any]], float],
              start: Optional[Mapping[str, Any]] = None, max_evals: int = 200,
              seed: int = 0) -> Tuple[Dict[str, Any], float,
                                      List[Tuple[Dict[str, Any], float]]]:
    """Deterministic best-improvement local search (lower score is better).

    ``score`` may return ``inf`` for infeasible points.  Revisited points are
    memoised here, and when ``score`` goes through an :class:`Explorer` the
    underlying graphs/simulations are cached too — re-scoring a neighbour
    costs a dictionary lookup, which is what makes the paper's
    "hypothesis → change → measure" iteration interactive.
    """
    def key(p: Mapping[str, Any]) -> Tuple:
        return tuple(p[a.name] for a in space.axes)

    seen: Dict[Tuple, float] = {}
    history: List[Tuple[Dict[str, Any], float]] = []

    def eval_point(p: Mapping[str, Any]) -> float:
        k = key(p)
        if k not in seen:
            seen[k] = float(score(p))
            history.append((dict(p), seen[k]))
        return seen[k]

    cur = dict(start) if start is not None else space.sample(1, seed)[0]
    cur_s = eval_point(cur)
    while len(history) < max_evals:
        best_nb, best_s = None, cur_s
        for nb in space.neighbors(cur):
            s = eval_point(nb)
            if s < best_s:
                best_nb, best_s = nb, s
            if len(history) >= max_evals:
                break
        if best_nb is None:
            break
        cur, cur_s = dict(best_nb), best_s
    return cur, cur_s, history


def parallel_map(fn: Callable[[Any], Any], items: Sequence[Any],
                 max_workers: Optional[int] = None) -> List[Any]:
    """Order-preserving map over a thread pool (serial when ≤1 worker)."""
    items = list(items)
    w = _resolve_workers(max_workers, len(items))
    if w <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=w) as ex:
        return list(ex.map(fn, items))


def _resolve_workers(max_workers: Optional[int], n_items: int) -> int:
    """Default is serial: the coarse simulator is pure Python (GIL-bound),
    so threads only pay off when the evaluation releases the GIL (torch/numpy
    -backed cost models, reference runs).  Callers opt in per sweep; result
    ordering is deterministic for every worker count either way."""
    if max_workers is None:
        return 1
    return max(1, min(max_workers, n_items))


# ---------------------------------------------------------------------------
# Lower bound (used by the pruning cut; exact w.r.t. conditional tasks)
# ---------------------------------------------------------------------------


def lower_bound_seconds(graph: TaskGraph) -> float:
    """A true lower bound on any schedule's makespan for ``graph``.

    Critical path with each task at its cheapest eligible device and
    conditional augmentation tasks at zero (``augment.lower_bound_cost`` —
    shared with ``FrozenGraph.freeze`` so fast- and reference-mode pruning
    can never diverge).
    """
    return graph.critical_path(lower_bound_cost)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    """Hit/miss accounting across the cache hierarchy.

    ``graph_*`` / ``eval_*`` count the in-memory layers; ``disk_*`` count
    consultations of the persistent store (only reached on an in-memory
    miss, so a cross-run warm sweep shows ``eval_misses == disk_hits``).

    The lane counters mirror the batch engines' fallback telemetry per
    explore call (see :class:`repro_torch.core.replay.BatchStats`):
    ``diverged_lanes`` failed a replay validation at least once,
    ``rescued_lanes`` were recovered by a later library order in lockstep,
    and ``serial_fallback_lanes`` degraded to a plain serial run with
    nothing recorded — the cost a warm order library drives to zero.

    The fault counters account for the recovery machinery (see the
    "Failure model" section of docs/architecture.md): ``worker_retries``
    chunks re-submitted after worker death, ``pool_respawns`` process
    pools replaced after breaking, ``chunk_timeouts`` chunk futures that
    exceeded their ``candidate_timeout`` budget, ``quarantined``
    candidates reported ``failed`` instead of killing the sweep,
    ``engine_demotions`` steps taken down the
    :data:`~repro_torch.core.replay.ENGINE_FALLBACK` chain, and
    ``cache_quarantined`` integrity-failed disk entries moved aside by
    this Explorer's own :class:`~repro_torch.core.diskcache.DiskCache` handle
    (worker-side handles quarantine independently).

    The retirement counters mirror the branch-and-bound fusion
    (``prune=True`` composed with the lockstep engines):
    ``retired_lanes`` lanes retired mid-sweep because their monotone
    partial bound crossed the incumbent cutoff, ``retire_sweeps``
    lockstep sweeps that retired at least one lane, and
    ``incumbent_updates`` cutoff tightenings folded in from the sweep's
    :class:`~repro_torch.core.replay.Incumbent` trackers (parent and
    worker-side).
    """

    graph_hits: int = 0
    graph_misses: int = 0
    eval_hits: int = 0
    eval_misses: int = 0
    disk_hits: int = 0
    disk_misses: int = 0
    diverged_lanes: int = 0
    rescued_lanes: int = 0
    serial_fallback_lanes: int = 0
    worker_retries: int = 0
    pool_respawns: int = 0
    chunk_timeouts: int = 0
    quarantined: int = 0
    engine_demotions: int = 0
    cache_quarantined: int = 0
    retired_lanes: int = 0
    retire_sweeps: int = 0
    incumbent_updates: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def __repr__(self) -> str:
        base = (f"CacheStats(graph {self.graph_hits}h/{self.graph_misses}m, "
                f"eval {self.eval_hits}h/{self.eval_misses}m, "
                f"disk {self.disk_hits}h/{self.disk_misses}m, "
                f"lanes {self.diverged_lanes}d/{self.rescued_lanes}r/"
                f"{self.serial_fallback_lanes}f")
        # fault telemetry appears only when something actually went wrong,
        # so the clean-run repr (pinned by the README doctest) stays short
        if any((self.worker_retries, self.pool_respawns,
                self.chunk_timeouts, self.quarantined,
                self.engine_demotions, self.cache_quarantined)):
            base += (f", faults {self.worker_retries}rt/"
                     f"{self.pool_respawns}rs/{self.chunk_timeouts}to/"
                     f"{self.quarantined}q/{self.engine_demotions}d/"
                     f"{self.cache_quarantined}cq")
        # likewise the retirement telemetry: only pruned sweeps show it
        if any((self.retired_lanes, self.retire_sweeps,
                self.incumbent_updates)):
            base += (f", retire {self.retired_lanes}l/"
                     f"{self.retire_sweeps}s/{self.incumbent_updates}u")
        return base + ")"


def _eligibility_signature(elig: Eligibility) -> Tuple:
    return (tuple(sorted((k, tuple(v))
                         for k, v in elig.kinds_by_kernel.items())),
            tuple(elig.default))


def _graph_key(system: SystemConfig, elig: Eligibility) -> Tuple:
    """Everything the augmented graph depends on besides the fixed trace /
    reports / SMP model held by the :class:`Explorer`.

    Pool *counts* deliberately do not appear: a 1-slot and a 2-slot fabric
    of the same kernel build the same graph — the big reuse win.
    """
    avail = frozenset(system.all_kinds()) | {r.name for r in system.shared}
    return (avail, system.task_creation_cost, system.dma_submit_cost,
            system.overlap_inputs, system.overlap_outputs,
            _eligibility_signature(elig))


def _sim_key(graph_key: Tuple, system: SystemConfig, policy: str,
             tier: str = "exact", ppa: Optional[str] = None) -> Tuple:
    pools = tuple((p.name, tuple(p.kinds), p.count) for p in system.pools)
    shared = tuple((r.name, r.count) for r in system.shared)
    # the tier keeps rtol-level (torch) results out of the exact engines'
    # cache namespace: a bit-identity contract must never be satisfied by
    # a cached rtol result.  The ppa token does the same for the
    # objective/budget configuration: a makespan-only entry must never
    # satisfy a PPA-annotated sweep's lookup (and vice versa)
    key = (graph_key, pools, shared, policy) if tier == "exact" \
        else (graph_key, pools, shared, policy, tier)
    return key if ppa is None else key + (ppa,)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CandidateOutcome:
    """Per-candidate record — serialisable, rich enough to re-rank offline."""

    name: str
    status: str                  # "ok" | "infeasible" | "pruned" | "failed"
    makespan_s: Optional[float] = None
    critical_path_s: Optional[float] = None
    lower_bound_s: Optional[float] = None
    analysis_seconds: float = 0.0
    cached_graph: bool = False
    cached_eval: bool = False
    bottleneck: str = ""
    rank: Optional[int] = None             # 0 = best; None if not ranked
    # status == "failed" (quarantined): repr of the captured exception;
    # status == "infeasible" under a PPA budget: the violated-axis reason
    error: Optional[str] = None
    # PPA mode only: all four objective values (makespan_s/area_mm2/
    # power_w/energy_j) and the per-pool component breakdown
    objectives: Optional[Dict[str, float]] = None
    ppa: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class ExplorationResult:
    """v2 exploration result: outcomes + ranked table + cache accounting.

    Keeps the seed API (``table`` / ``infeasible`` / ``best`` /
    ``wall_seconds`` / ``speedups`` / ``report_lines``) as properties so
    existing callers keep working.
    """

    outcomes: List[CandidateOutcome]
    wall_seconds: float
    policy: str = "availability"
    n_workers: int = 1
    top_k: Optional[int] = None
    cache: Dict[str, int] = dataclasses.field(default_factory=dict)
    # PPA mode only: the effective objective axes (canonical order) and
    # the budget bounds the sweep ran under
    objectives: Optional[List[str]] = None
    budgets: Optional[Dict[str, float]] = None
    # live estimates by candidate name; empty after JSON deserialisation
    estimates: Dict[str, PerfEstimate] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- ranking
    @property
    def ranked(self) -> List[CandidateOutcome]:
        ok = [o for o in self.outcomes if o.status == "ok"]
        return sorted(ok, key=lambda o: o.makespan_s)   # stable: input order ties

    @property
    def table(self) -> List[PerfEstimate]:
        return [self.estimates[o.name] for o in self.ranked
                if o.name in self.estimates]

    @property
    def infeasible(self) -> List[str]:
        return [o.name for o in self.outcomes if o.status == "infeasible"]

    @property
    def pruned(self) -> List[str]:
        return [o.name for o in self.outcomes if o.status == "pruned"]

    @property
    def failed(self) -> List[CandidateOutcome]:
        """Quarantined candidates: evaluation kept failing after every
        retry/fallback, so they were excised from the ranking instead of
        killing the sweep.  Each carries the captured exception repr in
        ``error``."""
        return [o for o in self.outcomes if o.status == "failed"]

    @property
    def best(self) -> Optional[PerfEstimate]:
        t = self.table
        return t[0] if t else None

    @property
    def best_name(self) -> Optional[str]:
        r = self.ranked
        return r[0].name if r else None

    def top(self, k: Optional[int] = None) -> List[CandidateOutcome]:
        k = k if k is not None else (self.top_k or len(self.outcomes))
        return self.ranked[:k]

    @property
    def frontier(self) -> List[CandidateOutcome]:
        """The Pareto frontier over this sweep's objective axes, in
        ``ranked`` (makespan) order.

        Membership depends only on the candidates' objective *values*
        (equal points both survive), so the frontier set is invariant
        under candidate permutation.  Without objectives it degenerates
        to the candidates tied for best makespan.  Derived from the
        outcomes, so it also works on a ``from_json``-restored result.
        """
        axes = list(self.objectives) if self.objectives else ["makespan_s"]
        ok = self.ranked
        pts = [o.objectives if o.objectives is not None
               else {"makespan_s": o.makespan_s} for o in ok]
        return [ok[i] for i in pareto_indices(pts, axes)]

    @property
    def dominated_count(self) -> int:
        """How many ``ok`` candidates some frontier member strictly
        dominates — the size of the trade-off the frontier summarises."""
        return len(self.ranked) - len(self.frontier)

    def speedups(self, baseline: Optional[str] = None) -> Dict[str, float]:
        # computed from outcomes (not live PerfEstimates) so it also works
        # on a from_json-restored result; same semantics as speedup_table
        times = {o.name: o.makespan_s for o in self.ranked}
        if not times:
            return {}
        ref = times[baseline] if baseline else max(times.values())
        return {name: ref / t for name, t in times.items()}

    # ------------------------------------------------------------ reporting
    def report_lines(self) -> List[str]:
        lines = [f"{'candidate':38s} {'est. time':>12s} {'speedup':>8s} "
                 f"{'bottleneck':>12s}"]
        ranked = self.ranked
        if not ranked:
            lines.append("  (no feasible candidate)")
        else:
            worst = max(o.makespan_s for o in ranked)
            for o in ranked:
                lines.append(f"{o.name:38s} {o.makespan_s * 1e3:10.3f}ms"
                             f" {worst / o.makespan_s:8.2f} {o.bottleneck:>12s}")
        for o in self.outcomes:
            if o.status == "ok":
                continue
            note = o.status if o.status != "pruned" else \
                f"pruned(lb {o.lower_bound_s * 1e3:.2f}ms)"
            lines.append(f"{o.name:38s} {'—':>12s} {'—':>8s} {note:>12s}")
            if o.status == "failed" and o.error:
                lines.append(f"  ^ quarantined: {o.error}")
        c = self.cache
        if c:
            lines.append(f"cache: graph {c.get('graph_hits', 0)}h/"
                         f"{c.get('graph_misses', 0)}m, eval "
                         f"{c.get('eval_hits', 0)}h/{c.get('eval_misses', 0)}m"
                         f" · workers={self.n_workers}")
            fault_keys = ("worker_retries", "pool_respawns", "chunk_timeouts",
                          "quarantined", "engine_demotions",
                          "cache_quarantined")
            if any(c.get(k, 0) for k in fault_keys):
                lines.append("faults: " + ", ".join(
                    f"{k.replace('_', ' ')} {c[k]}"
                    for k in fault_keys if c.get(k, 0)))
        if self.objectives:
            front = self.frontier
            lines.append(f"pareto frontier ({', '.join(self.objectives)}): "
                         f"{len(front)} of {len(self.ranked)} "
                         f"({self.dominated_count} dominated)")
            for o in front:
                vals = o.objectives or {"makespan_s": o.makespan_s}
                lines.append("  " + o.name + ": " + ", ".join(
                    f"{a}={vals[a]:.6g}" for a in (self.objectives or [])
                    if a in vals))
        lines.append(f"total analysis time: {self.wall_seconds:.3f}s")
        return lines

    # ----------------------------------------------------------------- JSON
    def to_json(self) -> str:
        doc = {
            "version": 2,
            "wall_seconds": self.wall_seconds,
            "policy": self.policy,
            "n_workers": self.n_workers,
            "top_k": self.top_k,
            "cache": dict(self.cache),
            "outcomes": [dataclasses.asdict(o) for o in self.outcomes],
        }
        # additive, PPA-mode only: scalar-mode documents stay byte-
        # identical to the pre-PPA format
        if self.objectives is not None:
            doc["objectives"] = list(self.objectives)
        if self.budgets is not None:
            doc["budgets"] = dict(self.budgets)
        return json.dumps(doc)

    @staticmethod
    def from_json(text: str) -> "ExplorationResult":
        d = json.loads(text)
        if d.get("version") != 2:
            raise ValueError(f"unsupported ExplorationResult version: "
                             f"{d.get('version')!r}")
        return ExplorationResult(
            outcomes=[CandidateOutcome(**o) for o in d["outcomes"]],
            wall_seconds=d["wall_seconds"], policy=d["policy"],
            n_workers=d["n_workers"], top_k=d["top_k"],
            cache=dict(d["cache"]),
            objectives=d.get("objectives"), budgets=d.get("budgets"))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


# Worker-persistent FrozenGraph registry.  A ``ProcessPoolExecutor`` worker
# initialised by ``_process_worker_init`` keeps every graph it has ever been
# handed (bounded LRU), keyed by content hash — the same sha256 fingerprint
# the on-disk store files entries under — so a graph crosses the process
# boundary at most once per worker per sweep, and with a ``cache_dir`` it
# usually crosses zero times (workers self-serve via ``DiskCache.get_hashed``).
_WORKER_GRAPHS: "collections.OrderedDict[str, FrozenGraph]" = \
    collections.OrderedDict()
_WORKER_GRAPH_CAP = 32
_WORKER_DISK: Optional[DiskCache] = None
# Worker-persistent order library: discovered dispatch orders outlive the
# chunk (and the Explorer) exactly like the graph registry, so repeat
# chunks — and repeat sweeps on the long-lived executor — replay warm.
# The parent additionally ships its own orders with every chunk and merges
# the worker's discoveries back, so knowledge flows both ways.
_WORKER_LIBRARY = ReplayLibrary()


def _process_worker_init(cache_dir: Optional[str],
                         fault_spec: Optional[str] = None,
                         fault_state: Optional[str] = None,
                         fault_token: Optional[str] = None) -> None:
    global _WORKER_DISK, _WORKER_LIBRARY
    # the fault plan rides the initializer (not just the environment): a
    # forkserver's server process is started once and never re-reads the
    # parent's later environment changes, so env inheritance alone would
    # miss plans activated after the first pool ever spawned.  The run
    # token rides along so the worker claims against the parent's one-shot
    # scope instead of minting (and sweeping) its own.
    faults.activate(fault_spec, fault_state, fault_token)
    _WORKER_DISK = DiskCache(cache_dir) if cache_dir else None
    _WORKER_GRAPHS.clear()
    _WORKER_LIBRARY = ReplayLibrary()


# One long-lived executor per (worker count, disk store, start method):
# spawning worker processes costs ~50-100ms — more than an entire
# 200-candidate batched sweep — so repeat sweeps must reuse the pool (and
# with it every worker's graph registry) instead of re-forking per
# `explore()` call.  Explorers sharing the key share the pool.  A small LRU
# (capacity 2, so a pattern alternating between e.g. a disk-backed and a
# plain sweep never thrashes) bounds idle workers; only the
# least-recently-used pool beyond that is retired.  Acquisition is locked —
# concurrent explores may share a pool, though two explores racing on
# *more than two distinct keys* can still retire a pool the other is using
# (bounded, documented trade-off).
_EXECUTORS: "collections.OrderedDict[Tuple[int, Optional[str], str], " \
            "ProcessPoolExecutor]" = collections.OrderedDict()
_EXECUTORS_CAP = 2
_EXECUTORS_LOCK = threading.Lock()


def _pool_mp_context() -> "multiprocessing.context.BaseContext":
    """The start method worker pools must use *right now*.

    Forking a process that has initialised CUDA gives a child whose CUDA
    state is unusable and whose CUDA runtime threads' locks are copied
    mid-state.  The torch engine initialises CUDA lazily, so pools created
    *before* it runs on the card can keep the cheap fork method; once
    ``torch.cuda.is_initialized()``, pools switch to ``forkserver`` (whose
    server process is started by a C-level fork+exec, never copying the
    parent's threads; ``spawn`` is the fallback where forkserver is
    unavailable).  The worker protocol is spawn-safe by construction:
    workers are seeded via the ``_process_worker_init`` initializer plus
    picklable chunk payloads, never via inherited module state.

    Evaluated per pool acquisition (the method is part of the executor
    key): an Explorer created before CUDA initialises and used after gets
    a fresh, correctly-started pool instead of the stale fork-method one.

    ``REPRO_POOL_START`` overrides the choice outright (``fork`` /
    ``forkserver`` / ``spawn``): a long-lived *multi-threaded* parent must
    never fork, CUDA or not, because a forked child inherits every other
    thread's locks mid-state.
    """
    methods = multiprocessing.get_all_start_methods()
    forced = os.environ.get("REPRO_POOL_START")
    if forced:
        if forced not in methods:
            raise ValueError(f"REPRO_POOL_START={forced!r}: not an "
                             f"available start method {methods}")
        return multiprocessing.get_context(forced)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        for m in ("forkserver", "spawn"):
            if m in methods:
                return multiprocessing.get_context(m)
    return multiprocessing.get_context(
        "fork" if "fork" in methods else methods[0])


def _shared_executor(procs: int,
                     cache_dir: Optional[str]) -> ProcessPoolExecutor:
    ctx = _pool_mp_context()
    # the active fault plan is part of the key: a changed plan must get
    # fresh workers, because the plan only reaches a worker through its
    # initializer (see _process_worker_init)
    key = (procs, cache_dir, ctx.get_start_method(), faults.token())
    fault_spec, fault_state, fault_token = faults.current()
    with _EXECUTORS_LOCK:
        ex = _EXECUTORS.get(key)
        if ex is not None and getattr(ex, "_broken", False):
            ex.shutdown(wait=False)
            del _EXECUTORS[key]
            ex = None
        if ex is None:
            ex = ProcessPoolExecutor(max_workers=procs,
                                     mp_context=ctx,
                                     initializer=_process_worker_init,
                                     initargs=(cache_dir, fault_spec,
                                               fault_state, fault_token))
            _EXECUTORS[key] = ex
        else:
            _EXECUTORS.move_to_end(key)
        while len(_EXECUTORS) > _EXECUTORS_CAP:
            _EXECUTORS.popitem(last=False)[1].shutdown(wait=False)
    return ex


def _retire_executor(ex: ProcessPoolExecutor) -> None:
    """Drop a broken executor from the shared registry and shut it down;
    the next :func:`_shared_executor` call spawns a fresh pool (whose
    workers re-seed their graph registries and order libraries through the
    normal chunk protocol)."""
    with _EXECUTORS_LOCK:
        for k, v in list(_EXECUTORS.items()):
            if v is ex:
                del _EXECUTORS[k]
                break
    try:
        ex.shutdown(wait=False, cancel_futures=True)
    except Exception:           # noqa: BLE001 — a pool so broken shutdown
        pass                    # itself raises is still retired


@atexit.register
def _shutdown_executors() -> None:
    with _EXECUTORS_LOCK:
        for ex in _EXECUTORS.values():
            ex.shutdown(wait=True)
        _EXECUTORS.clear()


def _process_eval_chunk(ghash: str, fg: Optional[FrozenGraph],
                        items: Sequence[Tuple[int, SystemConfig]],
                        policy: str, batch: bool,
                        orders: Optional[Mapping] = None,
                        max_rounds: int = MAX_RESCUE_ROUNDS,
                        prune_seed: Optional[Tuple] = None
                        ) -> Optional[Tuple]:
    """Worker-side unit: one graph (by registry hash, with the pickled
    payload riding along only on seeding chunks) × a slice of slot-count
    variants, evaluated in one lockstep batch (``batch=True``) or one
    ``simulate_fast`` loop.  ``orders`` is the parent's
    :meth:`~repro_torch.core.replay.ReplayLibrary.export` payload for this graph
    — merged (with validation) into the worker-persistent library so the
    chunk replays warm.  Returns ``None`` when the graph is known neither
    to the registry nor the disk store (the parent re-submits the chunk
    with the payload attached), else ``(results, orders_export,
    batch_stats_dict)``: the worker's full order set for the graph rides
    back so the parent can merge discoveries into the sweep library.
    Must stay module-level picklable.

    ``prune_seed`` is the parent's ``(cutoff, k, caps)`` snapshot at
    submit time: the worker rebuilds a *local* incumbent seeded with the
    parent's best-so-far cutoff (the k-th smallest over any superset is
    never larger than over this slice, so local tightening stays sound),
    arms per-lane energy caps, and retires lanes in flight exactly like
    the in-process path — retired slots come back as
    :class:`~repro_torch.core.replay.Retired` markers, and the local
    incumbent's tightenings fold into the returned stats dict."""
    # fault sites (no-ops without an active plan): a delayed chunk models a
    # straggling worker; a kill models a hard crash — os._exit skips every
    # finally/atexit, exactly like the OOM-killer, so the parent sees a
    # BrokenProcessPool with nothing salvageable
    faults.sleep_if_injected("delay_chunk")
    for _, system in items:
        if faults.fire("kill_worker") or \
                faults.fire("kill_candidate", getattr(system, "name", "")):
            os._exit(99)
    g = _WORKER_GRAPHS.get(ghash)
    if g is None:
        if fg is None and _WORKER_DISK is not None:
            got = _WORKER_DISK.get_hashed(ghash)
            if isinstance(got, FrozenGraph):
                fg = got
        if fg is None:
            return None
        _WORKER_GRAPHS[ghash] = g = fg
        while len(_WORKER_GRAPHS) > _WORKER_GRAPH_CAP:
            _, evicted = _WORKER_GRAPHS.popitem(last=False)
            # keep the order library bounded alongside the graph registry
            # (its discoveries already rode back to the parent per chunk)
            _WORKER_LIBRARY.drop_graph(evicted.content_hash())
    else:
        _WORKER_GRAPHS.move_to_end(ghash)
    if not batch:
        return ([(pos, simulate_fast(g, system, policy))
                 for pos, system in items], None, None)
    if orders:
        _WORKER_LIBRARY.merge(g, policy, orders)
    stats = BatchStats()
    pr = inc = None
    if prune_seed is not None:
        seed, k, caps = prune_seed
        if k > 0:
            inc = Incumbent(k, seed=seed)
        pr = PruneContext(inc, caps)
    sims = simulate_batch(g, [system for _, system in items], policy,
                          stats=stats, library=_WORKER_LIBRARY,
                          max_rounds=max_rounds, prune=pr)
    if inc is not None:
        stats.incumbent_updates += inc.updates
    return ([(pos, sim) for (pos, _), sim in zip(items, sims)],
            _WORKER_LIBRARY.export(g.content_hash(), policy),
            stats.as_dict())


#: Valid ``Explorer(engine=...)`` names, in fidelity order.  ``reference``
#: is the object engine, ``fast``/``batch`` the exact array engines, and
#: ``torch`` the rtol-tier step loop on the card (see
#: ``repro_torch.core.replay``) — the default.
ENGINE_NAMES = ("reference", "fast", "batch", "torch")


_COMPILE_CACHES: Dict[str, object] = {}
_COMPILE_CACHES_LOCK = threading.Lock()


def _shared_compile_cache(disk: DiskCache) -> "CompileCache":
    """The process-global :class:`~repro_torch.core.graphcache.CompileCache`
    for one cache root — Explorers sharing a ``cache_dir`` share captured
    runners (the memory tier), so a warm sweep never captures again per
    Explorer, and the root's kernel store serves later processes.
    CompileCache is internally locked, so sharing across threads is
    safe."""
    from .graphcache import CompileCache
    key = os.path.abspath(disk.root)
    with _COMPILE_CACHES_LOCK:
        cc = _COMPILE_CACHES.get(key)
        if cc is None:
            cc = _COMPILE_CACHES[key] = CompileCache(disk)
    return cc  # type: ignore[return-value]


def orders_disk_text(graph_token: str, policy: str,
                     ppa_token: Optional[str] = None) -> str:
    """On-disk key for one graph's order-library entry.

    Keyed by the FrozenGraph *content* hash + policy — plus, in PPA mode,
    the objective/budget configuration token: orders are engine-agnostic
    (recorded by the exact path, re-validated per lane by every backend),
    so one entry serves every engine tier, but never a different policy
    (the heap keys differ) and never a different objective configuration
    (a budgeted sweep prunes/simulates a different candidate population,
    so its discovered orders live in their own namespace).  Module-level
    so anything holding a shared
    :class:`~repro_torch.core.replay.ReplayLibrary` (the sweep server's drain
    flush, which runs scalar-mode with ``ppa_token=None``) can persist
    dirty orders with the exact key every Explorer reads back."""
    if ppa_token is None:
        return json.dumps(["orders", 1, graph_token, policy])
    return json.dumps(["orders", 1, graph_token, policy, ppa_token])


class Explorer:
    """Cached, parallel candidate evaluator bound to one trace.

    One instance per (trace × reports × SMP cost model × policy); evaluate
    as many candidate batches, hill-climbs or random sweeps against it as
    you like — graphs and simulations are shared across all of them.
    """

    def __init__(self, trace: Trace, reports: ReportMap, *,
                 policy: str = "availability", smp_scale: float = 1.0,
                 smp_seconds_fn: Optional[Callable] = None,
                 budget: Mapping[str, float] = ZYNQ_7045_BUDGET,
                 max_workers: Optional[int] = None, cache: bool = True,
                 fast: bool = True, batch: Optional[bool] = None,
                 processes: int = 0,
                 cache_dir: Optional[str] = None,
                 engine: Optional[str] = None,
                 device: Optional[str] = None,
                 torch_chunk: Optional[int] = None,
                 compile_cache: Optional["CompileCache"] = None,
                 order_library: Optional[ReplayLibrary] = None,
                 max_rescue_rounds: int = MAX_RESCUE_ROUNDS,
                 candidate_timeout: Optional[float] = None,
                 sweep_deadline: Optional[float] = None,
                 max_retries: int = MAX_CHUNK_RETRIES,
                 family_runner: Optional[Callable] = None,
                 objectives: Optional[Sequence[str]] = None,
                 budgets: Optional[Union[Budgets, Mapping[str,
                                                          float]]] = None,
                 hwspec: Optional[SpecLibrary] = None):
        """``engine`` names the evaluation engine directly — one of
        :data:`ENGINE_NAMES` — and overrides the legacy ``fast``/``batch``
        booleans (kept for compatibility: ``fast=False`` is
        ``engine="reference"``, ``fast=True, batch=False`` is
        ``engine="fast"``, ``batch=True`` is ``engine="batch"``; the
        default is ``engine="torch"``).
        ``engine="torch"`` evaluates each evaluation chunk's *whole* graph
        set through one lane axis of the torch step loop
        (:func:`repro_torch.core.torchsim.simulate_torch_many`, rtol-tier,
        in-process only) on ``device`` — default
        :func:`repro_torch.default_device`, the card; ``device="cpu"``
        asks for the host.  A missing card, a kernel that fails to build
        and a kernel launch that fails raise
        :class:`repro_torch.DeviceError`: they never demote.  On the card
        any other fault of the torch engine mid-sweep re-raises too.
        ``torch_chunk`` caps its lane-bucket width (non-power-of-two caps
        round down to a power of two).  The torch engine's step loop runs
        through the runners of a compile cache
        (:class:`~repro_torch.core.graphcache.CompileCache`; on the card a
        captured CUDA graph per shape signature): ``compile_cache`` shares
        an explicit one (overrides the ``cache_dir`` default); with a
        ``cache_dir`` the Explorers of one root share one, whose disk tier
        keeps the kernel libraries under ``<cache_dir>/kernels``; without
        either, Explorers share torchsim's process-wide in-memory cache.
        ``processes`` > 0 fans chunks out to that many worker processes
        (exact fast/batch engines only).  ``cache_dir`` persists frozen
        graphs and schedule-free sims to disk, keyed by trace content
        hash + eligibility/system signature (array engines only; torch-tier
        entries are namespaced so they can never satisfy an exact
        engine's lookup).  ``order_library`` shares a
        :class:`~repro_torch.core.replay.ReplayLibrary` of discovered dispatch
        orders across Explorers (default: a private one per instance);
        with ``cache_dir`` the orders also persist on disk, keyed by
        graph content hash + policy, so repeat sweeps and worker
        processes start warm.  ``max_rescue_rounds`` bounds the serial
        order discoveries per candidate group (see
        :func:`repro_torch.core.replay.replay_group`).

        Fault tolerance (see docs/architecture.md "Failure model"):
        ``candidate_timeout`` is the per-candidate evaluation deadline —
        a process chunk of *n* candidates gets ``n × candidate_timeout``
        seconds before it is cancelled, retried once serially in-parent,
        and quarantined if the serial retry also blows the budget.
        ``sweep_deadline`` bounds the whole ``explore()`` call; once it
        expires, every not-yet-evaluated candidate is quarantined
        (status ``"failed"``) instead of wedging the sweep.
        ``max_retries`` caps chunk re-submissions after a worker crash
        (capped exponential backoff between pool respawns) before the
        chunk is broken apart to isolate the poisoned candidate.  Engine
        faults (an injected torch activation fault, a lockstep engine
        error) demote the engine down the
        :data:`~repro_torch.core.replay.ENGINE_FALLBACK` chain — one warning
        per step, counted on ``stats.engine_demotions`` — instead of
        raising.

        ``family_runner`` delegates the in-process ``batch``-engine family
        evaluation to an external executor: called as ``family_runner(
        payload, systems, deadline_left_s)`` and expected to return one
        :class:`~repro_torch.core.simulator.SimResult` per system, bit-identical
        to :func:`~repro_torch.core.batchsim.simulate_batch` (the sweep server's
        cross-request coalescer is the intended runner).  Exceptions it
        raises demote the engine exactly like a local engine fault, except
        :class:`concurrent.futures.TimeoutError` — a missed deadline, not
        an engine fault — which quarantines via the isolation path without
        demoting.  Mutually exclusive with ``processes``.

        Multi-objective PPA ranking (docs/architecture.md
        "Multi-objective ranking"): ``objectives`` names the ranked axes
        (a subset of :data:`~repro_torch.core.hwspec.OBJECTIVE_NAMES`;
        ``makespan_s`` is always included) and ``budgets`` bounds them
        (a :class:`~repro_torch.core.hwspec.Budgets` or a strict mapping —
        unknown axes and non-positive values raise; budgeted axes join
        the objective set, which is what makes budget tightening
        monotone).  Either one switches the sweep into PPA mode: every
        simulated candidate is annotated with
        area/peak-power/energy from ``hwspec`` (default: a
        :class:`~repro_torch.core.hwspec.SpecLibrary` derived from this
        sweep's kernel reports), budget violations come back
        ``infeasible`` with the violated axis in ``error``, and
        ``ExplorationResult.frontier`` holds the Pareto set.  With more
        than one effective axis, the scalar lower-bound pruner is
        disabled (a makespan cut would discard slow-but-frugal frontier
        members); the exact energy pre-cut
        (``static_w × lower_bound > energy_j``) still applies.  All
        sim-cache and order-library keys are namespaced by the
        objective/budget configuration."""
        if engine is not None:
            if engine not in ENGINE_NAMES:
                raise ValueError(
                    f"unknown engine {engine!r}: valid engine names are "
                    + ", ".join(repr(e) for e in ENGINE_NAMES))
            fast = engine != "reference"
            batch = engine in ("batch", "torch")
        else:
            engine = "reference" if not fast else \
                ("torch" if batch is None else
                 "batch" if batch else "fast")
        self.engine = engine
        self.trace = trace
        self.reports = reports
        self.policy = policy
        self.smp_scale = smp_scale
        self.smp_seconds_fn = smp_seconds_fn
        self.budget = budget
        self.max_workers = max_workers
        self.cache_enabled = cache
        self.fast = fast
        self.batch = fast if batch is None else bool(batch)
        self.processes = int(processes or 0)
        if torch_chunk is not None:
            if torch_chunk < 1:
                raise ValueError(f"torch_chunk must be >= 1, got "
                                 f"{torch_chunk!r}")
            if engine != "torch":
                raise ValueError(f"torch_chunk only applies to "
                                 f"engine='torch' (got engine={engine!r})")
        self.torch_chunk = torch_chunk
        if device is not None and engine != "torch":
            raise ValueError(f"device only applies to engine='torch' "
                             f"(got engine={engine!r})")
        if compile_cache is not None and engine != "torch":
            raise ValueError(f"compile_cache only applies to engine='torch' "
                             f"(got engine={engine!r})")
        self._sim_tier = "torch" if engine == "torch" else "exact"
        self.device = None
        pending_demotion: Optional[BaseException] = None
        if engine == "torch":
            if self.processes:
                raise ValueError(
                    "engine='torch' is in-process (worker fan-out would "
                    "pay a device context and transfers per worker); use "
                    "engine='batch' with processes=N for process-parallel "
                    "sweeps")
            if max_workers is not None and max_workers > 1:
                raise ValueError(
                    "engine='torch' evaluates whole families on the device;"
                    " max_workers>1 would evaluate candidates one by one on"
                    " host threads instead")
            from .torchsim import require_torch, resolve_device
            # a missing card raises DeviceError here and never demotes
            self.device = resolve_device(device)
            try:
                require_torch()
            except RuntimeError as exc:  # an injected engine fault
                pending_demotion = exc   # degrades like the reference
        if not fast:
            if self.batch:
                raise ValueError("batch=True requires the fast engine "
                                 "(batchsim runs over FrozenGraph payloads)")
            if self.processes:
                raise ValueError("processes>0 requires the fast engine "
                                 "(picklable FrozenGraph payloads)")
            if cache_dir is not None:
                raise ValueError("cache_dir requires the fast engine "
                                 "(FrozenGraph is the on-disk payload)")
        if max_rescue_rounds < 0:
            raise ValueError(f"max_rescue_rounds must be >= 0, got "
                             f"{max_rescue_rounds!r}")
        if candidate_timeout is not None and candidate_timeout <= 0:
            raise ValueError(f"candidate_timeout must be > 0, got "
                             f"{candidate_timeout!r}")
        if sweep_deadline is not None and sweep_deadline <= 0:
            raise ValueError(f"sweep_deadline must be > 0, got "
                             f"{sweep_deadline!r}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{max_retries!r}")
        if family_runner is not None and self.processes:
            raise ValueError("family_runner and processes are mutually "
                             "exclusive (the runner owns the fan-out)")
        self.candidate_timeout = candidate_timeout
        self.sweep_deadline = sweep_deadline
        self.max_retries = int(max_retries)
        self.family_runner = family_runner
        # ----- multi-objective PPA configuration -----
        self.budgets = budgets if isinstance(budgets, (Budgets,
                                                       type(None))) \
            else Budgets.from_mapping(budgets)
        if objectives is not None or self.budgets is not None:
            self.objectives: Optional[Tuple[str, ...]] = \
                normalize_objectives(objectives, self.budgets)
            self.hwspec = hwspec if hwspec is not None \
                else SpecLibrary.from_reports(reports)
            self._ppa_token: Optional[str] = sha256_text(json.dumps(
                ["ppa", 1, self.hwspec.signature(), list(self.objectives),
                 self.budgets.as_dict() if self.budgets else None]))[:16]
        else:
            self.objectives = None
            self.hwspec = hwspec
            self._ppa_token = None
        self._disk = DiskCache(cache_dir) if cache_dir is not None else None
        if compile_cache is not None:
            self.compile_cache: Optional["CompileCache"] = compile_cache
        elif engine == "torch" and self._disk is not None:
            # one CompileCache per cache root, shared process-wide: a
            # fresh per-Explorer instance would start with an empty
            # memory tier and capture every runner again
            self.compile_cache = _shared_compile_cache(self._disk)
        else:
            # None ⇒ torchsim's process-wide in-memory cache: fresh
            # Explorers share captured runners within one process
            self.compile_cache = None
        self.stats = CacheStats()
        self.batch_stats = BatchStats()     # parent-side batchsim telemetry
        self.order_library = order_library if order_library is not None \
            else ReplayLibrary()
        self.max_rescue_rounds = int(max_rescue_rounds)
        self._orders_loaded: set = set()    # graph tokens read from disk
        self._ghashes: Dict[Tuple, str] = {}
        self._mem_ns = uuid.uuid4().hex[:12]
        self._shipped: Dict[str, int] = {}
        # graph_key -> (payload, graph_stats, critical_path_s, lower_bound_s)
        # where payload is a FrozenGraph (fast) or a TaskGraph (reference)
        self._graphs: Dict[Tuple, Tuple[object, Dict[str, object],
                                        float, float]] = {}
        self._sims: Dict[Tuple, SimResult] = {}
        self._lock = threading.Lock()
        # what every FrozenGraph of this trace shares, built on the first
        # graph miss (see _graph_for); never shared between Explorers
        self._analysis: Optional[TraceAnalysis] = None
        self._trace_fp: Optional[str] = None
        self._smp_tok: Optional[str] = None
        self._rep_tok: Optional[str] = None
        self._disk_texts: Dict[Tuple, str] = {}
        self._deadline: Optional[float] = None  # set per explore() call
        self._respawns = 0          # pool respawns this explore() call
        # branch-and-bound state, armed per explore() call when
        # prune=True: the live k-th-best incumbent (None in multi-axis
        # mode, where a scalar makespan cut is unsound) and the energy
        # budget backing the static_w × bound in-flight pre-cut
        self._incumbent: Optional[Incumbent] = None
        self._prune_energy_cap: Optional[float] = None
        # explore() mutates per-call state on self (_deadline, _respawns,
        # _shipped), so concurrent calls on ONE instance serialize here;
        # concurrent sweeps want one Explorer each, sharing order_library /
        # cache_dir / the process-pool registry (the sweep server's shape)
        self._explore_lock = threading.RLock()
        self._disk_q_seen = 0       # DiskCache.quarantined already folded
        if pending_demotion is not None:
            self._demote(pending_demotion)

    # --------------------------------------------------------- disk keys
    def _trace_fingerprint(self) -> str:
        # measured per-event times only shape graph costs when no
        # smp_seconds_fn overrides them (the fn's own outputs are
        # fingerprinted by _smp_fn_token) — excluding them lets a re-traced
        # run of the same program hit yesterday's entries
        if self._trace_fp is None:
            self._trace_fp = trace_fingerprint(
                self.trace, include_times=self.smp_seconds_fn is None)
        return self._trace_fp

    def _smp_fn_token(self) -> Optional[str]:
        """Content token for ``smp_seconds_fn``: the per-event costs it
        yields on this trace.  Two differently-coded functions with the same
        output share entries; a retuned model gets fresh ones."""
        if self.smp_seconds_fn is None:
            return None
        if self._smp_tok is None:
            vals = []
            for e in self.trace.events:
                try:
                    vals.append(repr(float(self.smp_seconds_fn(e))))
                except Exception:           # noqa: BLE001 — fn may reject
                    vals.append("!err")     # events outside its domain
            self._smp_tok = sha256_text(",".join(vals))
        return self._smp_tok

    def _reports_token(self) -> str:
        """Content token for the ReportMap: every cost field that shapes
        graph costs (folded_cost = dma_in + compute; dma_out feeds the
        xfer_out tasks).  A retuned HLS model must not reuse yesterday's
        on-disk graphs."""
        if self._rep_tok is None:
            items = sorted(
                (kernel, kind, r.compute_s, r.dma_in_s, r.dma_out_s)
                for (kernel, kind), r in self.reports.items())
            self._rep_tok = sha256_text(repr(items))
        return self._rep_tok

    def _graph_disk_text(self, graph_key: Tuple) -> str:
        # note: the eligibility element of graph_key is already the
        # canonical (sorted) _eligibility_signature tuple, so repr is
        # insertion-order insensitive
        cached = self._disk_texts.get(graph_key)
        if cached is not None:
            return cached
        avail, tcc, dsc, oi, oo, elig = graph_key
        text = json.dumps(
            ["graph", 1, self._trace_fingerprint(), sorted(avail), tcc, dsc,
             oi, oo, repr(elig), self.smp_scale, self._smp_fn_token(),
             self._reports_token()])
        self._disk_texts[graph_key] = text
        return text

    def _sim_disk_text(self, graph_key: Tuple, system: SystemConfig,
                       tier: Optional[str] = None) -> str:
        pools = [[p.name, list(p.kinds), p.count] for p in system.pools]
        shared = [[r.name, r.count] for r in system.shared]
        # exact engines share one on-disk namespace (their results are
        # interchangeable bit-for-bit); the torch tier gets its own tag so an
        # rtol-level entry can never satisfy an exact engine's lookup
        tier = self._sim_tier if tier is None else tier
        tag = "sim" if tier == "exact" else f"sim-{tier}"
        doc = [tag, 1, sha256_text(self._graph_disk_text(graph_key)),
               pools, shared, self.policy]
        if self._ppa_token is not None:
            # PPA mode gets its own namespace (see _sim_key): a
            # makespan-only entry must never satisfy this sweep's lookup
            doc.append(self._ppa_token)
        return json.dumps(doc)

    def _orders_disk_text(self, graph_token: str) -> str:
        """See :func:`orders_disk_text` (shared with the sweep server)."""
        return orders_disk_text(graph_token, self.policy, self._ppa_token)

    def _load_orders(self, payload: FrozenGraph) -> None:
        """Warm the order library from disk, once per graph per Explorer.
        Corrupted entries fail the DiskCache integrity check and stale or
        tampered payloads fail ``order_valid`` inside ``merge`` — either
        way the sweep falls back to rediscovery, never a wrong replay.
        Orders staged on the library (:func:`repro_torch.carry.
        import_reference`) are merged, with the same validation, first."""
        self.order_library.merge_staged(payload, self.policy)
        if self._disk is None:
            return
        token = payload.content_hash()
        if token in self._orders_loaded:
            return
        self._orders_loaded.add(token)
        got = self._disk.get(self._orders_disk_text(token))
        if isinstance(got, dict):
            self.order_library.merge(payload, self.policy, got,
                                     mark_dirty=False)

    def _save_orders(self) -> None:
        """Flush newly discovered orders to disk (end of every explore)."""
        if self._disk is None:
            return
        for token in self.order_library.take_dirty(self.policy):
            export = self.order_library.export(token, self.policy)
            if export:
                self._disk.put(self._orders_disk_text(token), export)

    # ------------------------------------------------- fault tolerance
    def _on_card(self) -> bool:
        """The sweep runs the torch engine on a CUDA device."""
        return self.engine == "torch" and self.device.type == "cuda"

    def _engine_fault(self, exc: BaseException) -> None:
        """An engine raised mid-sweep.  On the card every real fault
        re-raises: a sweep asked to run there neither moves to the host
        engines nor hides the fault behind a warning.  Elsewhere it
        demotes (:meth:`_demote`); the card's only demotions are injected
        faults (:class:`~repro_torch.testing.faults.InjectedFault`: the
        compile cache's ``fail_compile``) and ``fail_torch_import`` at
        construction."""
        if self._on_card() and not isinstance(exc, faults.InjectedFault):
            raise exc
        self._demote(exc)

    def _demote(self, exc: BaseException) -> None:
        """Step the sweep down the :data:`ENGINE_FALLBACK` chain after an
        engine fault — one warning, one counter tick — or re-raise when
        the chain is exhausted (``reference`` has nothing below it).

        Demotion is sticky for the Explorer's lifetime: an engine that
        faulted once is never trusted again by this instance.  Every tier
        at or below ``batch`` is exact, so the demoted sweep's results
        stay bit-identical to a healthy exact-engine run.

        A :class:`repro_torch.DeviceError` (the card, a kernel build or a
        kernel launch failed) is re-raised and never demotes: a sweep
        asked to run on the card does not quietly run elsewhere."""
        nxt = ENGINE_FALLBACK.get(self.engine)
        if nxt is None or isinstance(exc, DeviceError):
            raise exc
        warnings.warn(f"engine {self.engine!r} degraded to {nxt!r} for the "
                      f"rest of the sweep: {exc!r}", UserWarning,
                      stacklevel=3)
        self.stats.engine_demotions += 1
        self.engine = nxt
        self.fast = nxt != "reference"
        self.batch = nxt == "batch"
        self._sim_tier = "exact"
        if not self.fast:
            # cached FrozenGraph payloads are the wrong shape for the
            # reference engine; misses rebuild as TaskGraphs from here on
            with self._lock:
                self._graphs.clear()

    def _deadline_left(self) -> Optional[float]:
        """Seconds until this explore() call's sweep deadline (``None``
        without one; ``0.0`` once it has expired)."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.perf_counter())

    def _unit_timeout(self, n_items: int) -> Optional[float]:
        """Wall budget for one chunk future: per-candidate timeout scaled
        by the chunk width, clipped to the remaining sweep deadline."""
        t = None
        if self.candidate_timeout is not None:
            t = self.candidate_timeout * max(1, n_items)
        left = self._deadline_left()
        if left is not None:
            t = left if t is None else min(t, left)
        return t

    def _reference_sim(self, cand: Candidate) -> SimResult:
        """The bottom of the fallback chain: rebuild the candidate's graph
        as plain objects and run the reference engine — no FrozenGraph, no
        lockstep, no device anywhere on the path."""
        g = build_graph(self.trace, cand.system, self.reports,
                        cand.eligibility, smp_scale=self.smp_scale,
                        smp_cost="mean", smp_seconds_fn=self.smp_seconds_fn)
        return simulate(g, cand.system, policy=self.policy)

    def _fire_inline_kills(self, name: str) -> None:
        """The worker kill sites, honoured during in-parent isolation: a
        candidate poisonous enough to kill every worker that touches it
        must also fail its serial retry — in the parent that is a raise
        (captured and quarantined), never ``os._exit``."""
        if faults.fire("kill_worker") or faults.fire("kill_candidate", name):
            raise RuntimeError(
                f"injected fault: kill during serial isolation of {name!r}")

    def _failed_outcome(self, cand: Candidate, exc: BaseException,
                        t0: float) -> Tuple[None, CandidateOutcome]:
        self.stats.quarantined += 1
        return None, CandidateOutcome(
            name=cand.name, status="failed",
            analysis_seconds=time.perf_counter() - t0, error=repr(exc))

    def _safe_outcome(self, cand: Candidate) \
            -> Tuple[Optional[PerfEstimate], CandidateOutcome]:
        """The per-candidate (serial / thread-pool) path inside the fault
        envelope: expired sweep deadline and any evaluation exception
        quarantine the candidate instead of killing the sweep."""
        tc = time.perf_counter()
        if self._deadline_left() == 0.0:
            return self._failed_outcome(
                cand, FuturesTimeout("sweep deadline exceeded"), tc)
        try:
            self._fire_inline_kills(cand.name)
            return self._evaluate_outcome(cand)
        except Exception as exc:            # noqa: BLE001 — quarantine
            return self._failed_outcome(cand, exc, tc)

    def _isolate_candidates(self, payload: object, ginfo: Tuple,
                            items: Sequence[Tuple], results: List) -> None:
        """Bisection taken to its fixpoint: each candidate of a failed or
        timed-out chunk is re-evaluated *alone*, in-parent, on the exact
        per-candidate path (the only environment that survives a worker
        kill).  Survivors keep bit-identical results; repeat offenders are
        quarantined with the captured exception.  An expired sweep
        deadline quarantines the remainder without evaluating."""
        _, stats, crit, lb = ginfo
        for pos, cand, key, text, ghit in items:
            tc = time.perf_counter()
            if self._deadline_left() == 0.0:
                results[pos] = self._failed_outcome(
                    cand, FuturesTimeout("sweep deadline exceeded"), tc)
                continue
            try:
                self._fire_inline_kills(cand.name)
                faults.sleep_if_injected("delay_chunk")
                if self.fast:
                    sim = simulate_fast(payload, cand.system, self.policy)
                else:
                    sim = self._reference_sim(cand)
                dt = time.perf_counter() - tc
                if self.candidate_timeout is not None \
                        and dt > self.candidate_timeout:
                    raise FuturesTimeout(
                        f"serial retry took {dt:.3f}s > candidate_timeout="
                        f"{self.candidate_timeout}")
            except Exception as exc:        # noqa: BLE001 — quarantine
                results[pos] = self._failed_outcome(cand, exc, tc)
                continue
            self._sim_store(key, text, sim)
            results[pos] = self._outcome_from_sim(
                cand, stats, crit, lb, ghit, False, sim,
                time.perf_counter() - tc)

    # ------------------------------------------------------------------
    def _graph_for(self, cand: Candidate,
                   gkey: Optional[Tuple] = None
                   ) -> Tuple[object, Dict[str, object], float, float, bool]:
        key = gkey if gkey is not None \
            else _graph_key(cand.system, cand.eligibility)
        with self._lock:
            hit = self.cache_enabled and key in self._graphs
            if hit:
                self.stats.graph_hits += 1
                return (*self._graphs[key], True)
            self.stats.graph_misses += 1
        with tracing.span("graph.build"):
            return self._graph_miss(cand, key)

    def _graph_miss(self, cand: Candidate, key: Tuple
                     ) -> Tuple[object, Dict[str, object], float, float, bool]:
        """A graph-cache miss: the disk tier, else a build.  The array
        engines assemble their ``FrozenGraph`` straight from the trace
        analysis (``TraceAnalysis.frozen_graph``, equal to freezing
        ``build_graph``'s output); the reference engine builds the
        ``TaskGraph`` it walks."""
        text = None
        if self._disk is not None:
            text = self._graph_disk_text(key)
            fg = self._disk.get(text)
            if isinstance(fg, FrozenGraph):
                entry = (fg, fg.stats, fg.critical_path_s, fg.lower_bound_s)
                with self._lock:
                    self.stats.disk_hits += 1
                    if self.cache_enabled:
                        self._graphs[key] = entry
                return (*entry, True)
            with self._lock:
                self.stats.disk_misses += 1
        if self.fast:
            fg = self._trace_analysis().frozen_graph(
                cand.system, self.reports, cand.eligibility)
            entry = (fg, fg.stats, fg.critical_path_s, fg.lower_bound_s)
        else:
            g = build_graph(self.trace, cand.system, self.reports,
                            cand.eligibility, smp_scale=self.smp_scale,
                            smp_cost="mean",
                            smp_seconds_fn=self.smp_seconds_fn)
            entry = (g, g.subgraph_stats(), g.critical_path(),
                     lower_bound_seconds(g))
        if text is not None:
            self._disk.put(text, entry[0])
        if self.cache_enabled:
            with self._lock:
                self._graphs[key] = entry
        return (*entry, False)

    def _trace_analysis(self) -> TraceAnalysis:
        with self._lock:
            if self._analysis is None:
                self._analysis = TraceAnalysis(
                    self.trace, smp_scale=self.smp_scale, smp_cost="mean",
                    smp_seconds_fn=self.smp_seconds_fn)
            return self._analysis

    # ------------------------------------------------------------------
    def evaluate(self, cand: Candidate) -> PerfEstimate:
        """One candidate through the cached pipeline (no pruning).

        Unlike batch exploration (schedule-free, top-k records only), the
        single-candidate API always returns a full schedule — callers feed
        it straight to ``ascii_gantt`` / ``write_prv``."""
        est, out = self._evaluate_outcome(cand)
        if est is None:
            reason = out.error or "does not fit the fabric budget"
            raise ValueError(f"candidate {cand.name!r} is infeasible: "
                             f"{reason}")
        if self.fast and not est.sim.schedule:
            est.sim = self._full_schedule_sim(cand)
        return est

    def _full_schedule_sim(self, cand: Candidate) -> SimResult:
        """Re-simulate one candidate with ScheduledTask records (fast mode)."""
        entry = self._graphs.get(_graph_key(cand.system, cand.eligibility))
        payload = entry[0] if entry is not None else self._graph_for(cand)[0]
        return simulate_fast(payload, cand.system, self.policy,
                             with_schedule=True)

    def _infeasible_outcome(self, cand: Candidate,
                            t0: float) -> Optional[CandidateOutcome]:
        if cand.fabric and not cand.feasible(self.budget):
            return CandidateOutcome(
                name=cand.name, status="infeasible",
                analysis_seconds=time.perf_counter() - t0)
        if self.budgets is not None and (
                self.budgets.area_mm2 is not None
                or self.budgets.power_w is not None):
            # area and peak power are spec arithmetic on the pool layout —
            # simulation-free, so over-budget candidates are rejected
            # before any graph is built
            ppa0 = self.hwspec.annotate(cand.system, 0.0, {})
            reason = self.budgets.violation(
                {"area_mm2": ppa0.area_mm2, "power_w": ppa0.power_w})
            if reason is not None:
                return CandidateOutcome(
                    name=cand.name, status="infeasible", error=reason,
                    analysis_seconds=time.perf_counter() - t0)
        return None

    def _evaluate_outcome(self, cand: Candidate) \
            -> Tuple[Optional[PerfEstimate], CandidateOutcome]:
        t0 = time.perf_counter()
        infeasible = self._infeasible_outcome(cand, t0)
        if infeasible is not None:
            return None, infeasible
        payload, stats, crit, lb, ghit = self._graph_for(cand)
        sim, ehit = self._simulate(payload, cand)
        dt = time.perf_counter() - t0
        return self._outcome_from_sim(cand, stats, crit, lb, ghit, ehit,
                                      sim, dt)

    def _outcome_from_sim(self, cand: Candidate, stats: Dict[str, object],
                          crit: float, lb: float, ghit: bool, ehit: bool,
                          sim: Union[SimResult, Retired], dt: float) \
            -> Tuple[Optional[PerfEstimate], CandidateOutcome]:
        if isinstance(sim, Retired):
            # in-flight retirement: the engine proved the lane's final
            # makespan exceeds sim.bound.  Past the energy cap that is
            # provable infeasibility; past the incumbent cutoff it is a
            # pruned lane — either way it is reported with its bound,
            # never silently ranked
            bound = sim.bound if lb is None else max(float(lb), sim.bound)
            status, err = "pruned", None
            if self._prune_energy_cap is not None:
                floor = self.hwspec.annotate(
                    cand.system, 0.0, {}).static_w * sim.bound
                if floor > self._prune_energy_cap:
                    status = "infeasible"
                    err = (f"energy_j lower bound {floor:.6g} exceeds "
                           f"budget {self._prune_energy_cap:.6g}")
            return None, CandidateOutcome(
                name=cand.name, status=status, critical_path_s=crit,
                lower_bound_s=bound, analysis_seconds=dt,
                cached_graph=ghit, cached_eval=ehit, error=err)
        objs = ppa_doc = None
        if self.objectives is not None:
            # the single seam every engine path funnels through: annotate
            # post-sim (pure spec arithmetic — the sims themselves stay
            # bit-identical across engines) and enforce the energy budget
            ppa = self.hwspec.annotate(cand.system, sim.makespan, sim.busy,
                                       sim.pool_slots)
            objs = ppa.objectives()
            ppa_doc = ppa.as_dict()
            if self.budgets is not None:
                reason = self.budgets.violation(objs)
                if reason is not None:
                    # no PerfEstimate: an over-budget candidate must not
                    # enter ok_makespans (it would tighten the scalar
                    # prune threshold with a makespan nobody may pick)
                    return None, CandidateOutcome(
                        name=cand.name, status="infeasible",
                        makespan_s=sim.makespan, critical_path_s=crit,
                        lower_bound_s=lb, analysis_seconds=dt,
                        cached_graph=ghit, cached_eval=ehit,
                        bottleneck=sim.bottleneck(), error=reason,
                        objectives=objs, ppa=ppa_doc)
        if self._incumbent is not None:
            # the cross-family (and cache-hit) tightening seam: every ok
            # makespan — offers are name-keyed, so re-offering a value
            # the engine already folded in is a no-op
            self._incumbent.offer(cand.name, sim.makespan)
        est = PerfEstimate(candidate=cand.name, makespan_s=sim.makespan,
                           sim=sim, graph_stats=stats, critical_path_s=crit,
                           analysis_seconds=dt)
        return est, CandidateOutcome(
            name=cand.name, status="ok", makespan_s=sim.makespan,
            critical_path_s=crit, lower_bound_s=lb, analysis_seconds=dt,
            cached_graph=ghit, cached_eval=ehit,
            bottleneck=sim.bottleneck(), objectives=objs, ppa=ppa_doc)

    def _sim_lookup(self, cand: Candidate, gkey: Optional[Tuple] = None) \
            -> Tuple[Tuple, Optional[str], Optional[SimResult]]:
        """Consult the in-memory then on-disk sim caches (no compute).

        Returns ``(mem_key, disk_text, hit-or-None)`` and does all the
        hit/miss accounting for the lookup."""
        if gkey is None:
            gkey = _graph_key(cand.system, cand.eligibility)
        key = _sim_key(gkey, cand.system, self.policy, self._sim_tier,
                       self._ppa_token)
        with self._lock:
            if self.cache_enabled and key in self._sims:
                self.stats.eval_hits += 1
                return key, None, self._sims[key]
            self.stats.eval_misses += 1
        if self._disk is None:
            return key, None, None
        text = self._sim_disk_text(gkey, cand.system)
        hit = self._disk.get(text)
        if not isinstance(hit, SimResult) and self._sim_tier != "exact":
            # tier blocking is one-directional: an exact entry trivially
            # satisfies any relaxed tier, so a warm exact-engine store also
            # serves torch re-ranks (the reverse stays blocked — see above)
            hit = self._disk.get(
                self._sim_disk_text(gkey, cand.system, "exact"))
        with self._lock:
            if isinstance(hit, SimResult):
                self.stats.disk_hits += 1
            else:
                self.stats.disk_misses += 1
                hit = None
        if hit is not None and self.cache_enabled:
            with self._lock:
                self._sims[key] = hit
        return key, text, hit

    def _sim_store(self, key: Tuple, text: Optional[str],
                   sim: SimResult) -> None:
        if text is not None:
            self._disk.put(text, sim)
        if self.cache_enabled:
            with self._lock:
                self._sims[key] = sim

    def _simulate(self, payload: object,
                  cand: Candidate) -> Tuple[SimResult, bool]:
        key, text, hit = self._sim_lookup(cand)
        if hit is not None:
            return hit, True
        if self.fast:
            sim = simulate_fast(payload, cand.system, self.policy)
        else:
            sim = simulate(payload, cand.system, policy=self.policy)
        self._sim_store(key, text, sim)
        return sim, False

    # ------------------------------------------------------------------
    def explore(self, candidates: Sequence[Candidate], *,
                top_k: Optional[int] = None,
                prune: bool = False,
                deadline_s: Optional[float] = None) -> ExplorationResult:
        """Evaluate a candidate batch → ranked :class:`ExplorationResult`.

        ``prune=True`` enables branch-and-bound pruning against the
        incumbent (the k-th best makespan so far, k = ``top_k`` or 1),
        at two levels: a candidate whose static critical-path bound is
        already *strictly worse* than the cutoff is recorded as
        ``pruned`` without simulating, and — composed with the lockstep
        engines (``batch``/``torch``) — lanes whose monotone partial bound
        crosses the cutoff are *retired mid-sweep* (energy budgets add a
        ``static_w × bound`` pre-cut that retires provably over-budget
        lanes as ``infeasible``).  Every bound is exact, so the optimum,
        the full top-k set and the Pareto frontier are never discarded;
        only the tail of the ranking loses its exact makespans.  The
        incumbent only ever tightens and retirement is strict, so the
        reported top-k is bit-identical to the unpruned sweep on the
        exact engines regardless of worker timing.

        ``deadline_s`` overrides the constructor's ``sweep_deadline`` for
        this call only — the sweep server derives it per request from the
        client budget minus the admission queue wait.  Concurrent calls
        on one instance serialize on an internal lock (per-call state
        lives on ``self``); concurrent *sweeps* should use one Explorer
        each and share ``order_library``/``cache_dir`` instead.
        """
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s!r}")
        with self._explore_lock:
            return self._explore(candidates, top_k=top_k, prune=prune,
                                 deadline_s=deadline_s)

    @tracing.spanned("sweep")
    def _explore(self, candidates: Sequence[Candidate], *,
                 top_k: Optional[int], prune: bool,
                 deadline_s: Optional[float]) -> ExplorationResult:
        t0 = time.perf_counter()
        eff_deadline = deadline_s if deadline_s is not None \
            else self.sweep_deadline
        self._deadline = None if eff_deadline is None \
            else t0 + eff_deadline
        self._respawns = 0
        stats_before = self.stats.as_dict()
        bstats_before = self.batch_stats.as_dict()
        cands = list(candidates)
        use_procs = self.fast and self.processes > 0 and len(cands) > 1
        n_workers = self.processes if use_procs \
            else _resolve_workers(self.max_workers, len(cands))
        outcomes: List[Optional[CandidateOutcome]] = [None] * len(cands)
        estimates: Dict[str, PerfEstimate] = {}
        kk = max(1, top_k) if top_k is not None else 1
        # with more than one objective axis, the scalar makespan cut is
        # unsound — it would discard slow-but-frugal frontier members —
        # so the lower-bound pruner only runs in single-axis mode
        multi_axis = self.objectives is not None and len(self.objectives) > 1
        energy_cap = self.budgets.energy_j if self.budgets is not None \
            else None
        # the branch-and-bound incumbent: every ok outcome offers its
        # makespan (at the _outcome_from_sim seam, so cache hits count
        # too) and the k-th best so far is the live retirement cutoff —
        # threaded into the lockstep engines per family and shipped to
        # process workers per chunk
        self._incumbent = Incumbent(kk) if prune and not multi_axis \
            else None
        self._prune_energy_cap = energy_cap if prune else None

        def threshold() -> Optional[float]:
            if self._incumbent is None:
                return None
            cut = self._incumbent.get()
            return cut if cut != float("inf") else None

        pool = ThreadPoolExecutor(max_workers=n_workers) \
            if not use_procs and n_workers > 1 else None
        self._shipped = {}          # payload-seeding ledger, per executor
        try:
            chunk = self._chunk_size(
                len(cands), prune, self.processes if use_procs else 0,
                self.batch and not use_procs and pool is None,
                n_workers)
            for base in range(0, len(cands), chunk):
                batch: List[Tuple[int, Candidate]] = []
                with tracing.span("sweep.prepare"):
                    for i in range(base, min(base + chunk, len(cands))):
                        cand = cands[i]
                        tc = time.perf_counter()
                        infeasible = self._infeasible_outcome(cand, tc)
                        if infeasible is not None:
                            outcomes[i] = infeasible
                            continue
                        if energy_cap is not None:
                            # exact pre-cut composed with the lower-bound
                            # machinery: energy >= static_w × makespan >=
                            # static_w × lower_bound, so exceeding the cap
                            # here is provable infeasibility, not a heuristic
                            # prune (the graph/bound is cached work anyway)
                            _, _, crit, lb, ghit = self._graph_for(cand)
                            floor = self.hwspec.annotate(
                                cand.system, 0.0, {}).static_w * lb
                            if floor > energy_cap:
                                outcomes[i] = CandidateOutcome(
                                    name=cand.name, status="infeasible",
                                    critical_path_s=crit, lower_bound_s=lb,
                                    cached_graph=ghit,
                                    error=f"energy_j lower bound {floor:.6g} "
                                          f"exceeds budget {energy_cap:.6g}",
                                    analysis_seconds=time.perf_counter() - tc)
                                continue
                        cut = threshold()
                        if cut is not None:
                            # the graph (hence the bound) is cached work anyway
                            _, _, crit, lb, ghit = self._graph_for(cand)
                            if lb > cut:
                                outcomes[i] = CandidateOutcome(
                                    name=cand.name, status="pruned",
                                    critical_path_s=crit, lower_bound_s=lb,
                                    cached_graph=ghit,
                                    analysis_seconds=time.perf_counter() - tc)
                                continue
                        batch.append((i, cand))
                # engine demotion may have dropped self.fast / self.batch
                # since the last chunk — re-resolve the dispatch each time.
                # the lockstep batch engine composes with pruning now:
                # the incumbent cutoff rides into the sweep itself (lanes
                # retire in flight), so chunk boundaries only matter for
                # the cheap lower-bound pre-cut above
                procs_now = use_procs and self.fast
                use_batch = self.batch and not procs_now and pool is None
                if procs_now or use_batch:
                    results = self._evaluate_batch_grouped(procs_now, batch)
                elif pool is not None:
                    results = list(pool.map(
                        lambda ic: self._safe_outcome(ic[1]), batch))
                else:
                    results = [self._safe_outcome(c) for _, c in batch]
                for (i, cand), (est, out) in zip(batch, results):
                    outcomes[i] = out
                    if est is not None:
                        estimates[cand.name] = est
        finally:
            if pool is not None:
                pool.shutdown()
            self._deadline = None
            if self._incumbent is not None:
                # the parent incumbent's tightenings join the worker-side
                # ones already folded through BatchStats.add_dict
                self.batch_stats.incumbent_updates += \
                    self._incumbent.updates
            self._incumbent = None
            self._prune_energy_cap = None
            # the process pool is the shared, worker-persistent executor —
            # it outlives this call so repeat sweeps reuse the workers'
            # graph registries

        done = [o for o in outcomes if o is not None]
        assert len(done) == len(cands)
        # mirror this call's batch-engine fallback telemetry into the
        # cache counters: how
        # many lanes diverged from a replayed order, how many the library
        # rescued back into lockstep, how many degraded to serial
        bstats = self.batch_stats.as_dict()
        self.stats.diverged_lanes += \
            bstats["diverged_lanes"] - bstats_before["diverged_lanes"]
        self.stats.rescued_lanes += \
            bstats["rescued_lanes"] - bstats_before["rescued_lanes"]
        self.stats.serial_fallback_lanes += \
            bstats["serial_fallback_lanes"] \
            - bstats_before["serial_fallback_lanes"]
        self.stats.retired_lanes += \
            bstats["retired_lanes"] - bstats_before["retired_lanes"]
        self.stats.retire_sweeps += \
            bstats["retire_sweeps"] - bstats_before["retire_sweeps"]
        self.stats.incumbent_updates += \
            bstats["incumbent_updates"] - bstats_before["incumbent_updates"]
        # fold integrity-failed disk entries this Explorer's own DiskCache
        # handle moved aside (worker-side handles quarantine independently)
        if self._disk is not None:
            self.stats.cache_quarantined += \
                self._disk.quarantined - self._disk_q_seen
            self._disk_q_seen = self._disk.quarantined
        # per-call delta, not the Explorer's lifetime totals — a stored
        # sweep must account for its own batch only
        cache = {k: v - stats_before[k]
                 for k, v in self.stats.as_dict().items()}
        with tracing.span("sweep.assemble"):
            result = ExplorationResult(
                outcomes=done, wall_seconds=time.perf_counter() - t0,
                policy=self.policy, n_workers=n_workers, top_k=top_k,
                cache=cache, estimates=estimates,
                objectives=list(self.objectives)
                if self.objectives is not None else None,
                budgets=self.budgets.as_dict()
                if self.budgets is not None else None)
            for rank, o in enumerate(result.ranked):
                o.rank = rank
        with tracing.span("sweep.schedules"):
            self._materialise_schedules(result, cands, estimates, kk)
        with tracing.span("sweep.save_orders"):
            self._save_orders()
        return result

    def _chunk_size(self, n_cands: int, prune: bool, procs: int,
                    use_batch: bool, n_workers: int) -> int:
        """Adaptive chunking (replaces the fixed ``procs * 32``).

        Without pruning there is nothing to learn between chunks, so the
        whole candidate set goes out as one deterministic chunk — the
        batch engine sees every graph-sharing family intact, and process
        workers get the per-graph slices re-balanced across the whole
        sweep instead of per-64-candidate window.  The lockstep engines
        keep the whole-sweep chunk even under pruning: the incumbent
        rides *into* the sweep (in-flight retirement), so splitting
        families to re-test a chunk-boundary cut would only shrink
        lockstep groups.  Serial and process paths still re-test the
        static lower-bound cut at chunk boundaries, so with pruning they
        aim for a few chunks per worker in a sane [24, 256] band.
        """
        if procs > 0:
            if prune:
                return max(24, min(256, -(-n_cands // (procs * 4))))
            return max(1, n_cands)
        if use_batch:
            return max(1, n_cands)
        return max(1, n_workers)

    def _graph_hash(self, gkey: Tuple) -> str:
        """Registry key for a graph: the on-disk sha256 fingerprint when a
        store is configured (workers can then self-serve the payload via
        ``DiskCache.get_hashed``), else a process-unique token — workers
        outlive Explorer instances, so the token must never be reused by a
        later Explorer (uuid, not ``id(self)``)."""
        h = self._ghashes.get(gkey)
        if h is None:
            if self._disk is not None:
                h = sha256_text(self._graph_disk_text(gkey))
            else:
                h = f"mem-{self._mem_ns}-{len(self._ghashes)}"
            self._ghashes[gkey] = h
        return h

    def _evaluate_batch_grouped(self, use_procs: bool,
                                batch: Sequence[Tuple[int, Candidate]]) \
            -> List[Tuple[Optional[PerfEstimate], CandidateOutcome]]:
        """One deterministic chunk, grouped by shared graph.

        Graphs are built (or fetched) in the parent so cache accounting
        stays per candidate and cache hits never reach a worker; the
        remaining misses are evaluated per graph-sharing family — locally
        through the lockstep batch engine (``use_procs=False``), or sliced
        across worker processes that resolve the graph from their
        persistent registry (payload pickled at most once per worker, or
        not at all when the disk store already holds it).  Results are
        reassembled by batch position, so the outcome is bit-identical to
        the per-candidate serial path.

        Failures never escape this method: engine faults demote down the
        fallback chain, worker crashes and timeouts retry and then isolate
        per candidate, and candidates that keep failing come back with
        status ``"failed"`` (see docs/architecture.md "Failure model")."""
        results: List = [None] * len(batch)
        # graph_key -> [(pos, cand, mem_key, disk_text, ghit)]
        pending: Dict[Tuple, List[Tuple]] = {}
        graph_info: Dict[Tuple, Tuple] = {}
        with tracing.span("sweep.prepare"):
            for pos, (_, cand) in enumerate(batch):
                tc = time.perf_counter()
                gkey = _graph_key(cand.system, cand.eligibility)
                payload, stats, crit, lb, ghit = self._graph_for(cand, gkey)
                key, text, hit = self._sim_lookup(cand, gkey)
                if hit is not None:
                    results[pos] = self._outcome_from_sim(
                        cand, stats, crit, lb, ghit, True, hit,
                        time.perf_counter() - tc)
                    continue
                graph_info[gkey] = (payload, stats, crit, lb)
                pending.setdefault(gkey, []).append(
                    (pos, cand, key, text, ghit))

        if not use_procs:                      # serial lockstep evaluation
            if self.engine == "torch" and pending:
                try:
                    return self._evaluate_megabatch(pending, graph_info,
                                                    results)
                except Exception as exc:    # noqa: BLE001 — engine fault:
                    self._engine_fault(exc)  # re-run below, demoted tier
            for gkey, items in pending.items():
                payload, stats, crit, lb = graph_info[gkey]
                if self._deadline_left() == 0.0:
                    self._isolate_candidates(payload, graph_info[gkey],
                                             items, results)
                    continue
                t0 = time.perf_counter()
                fam = [cand for _, cand, _, _, _ in items]
                try:
                    sims = self._lockstep_family(payload, fam,
                                                 self._family_prune(fam))
                except Exception as exc:    # noqa: BLE001 — fallback
                    if isinstance(exc, DeviceError) or (
                            self._on_card() and not isinstance(
                                exc, faults.InjectedFault)):
                        raise       # never isolated onto the host
                    # chain exhausted mid-family: isolate (quarantines
                    # repeaters)
                    self._isolate_candidates(payload, graph_info[gkey],
                                             items, results)
                    continue
                share = (time.perf_counter() - t0) / max(len(items), 1)
                with tracing.span("sweep.assemble"):
                    for (pos, cand, key, text, ghit), sim in zip(items,
                                                                 sims):
                        if not isinstance(sim, Retired):
                            # a retirement marker is not a result: it
                            # must never satisfy a later (possibly
                            # unpruned) lookup
                            self._sim_store(key, text, sim)
                        results[pos] = self._outcome_from_sim(
                            cand, stats, crit, lb, ghit, False, sim, share)
            return results
        return self._evaluate_process_chunks(pending, graph_info, results)

    def _evaluate_process_chunks(self, pending: Mapping[Tuple,
                                                        Sequence[Tuple]],
                                 graph_info: Mapping[Tuple, Tuple],
                                 results: List) -> List:
        """The process-pool path as a unit-based retry state machine.

        Each *unit* is one (graph, candidate-slice) worker chunk.  Units
        are submitted eagerly and drained in submission order; a unit's
        failure mode decides its path:

        * **worker crash** (``BrokenProcessPool``): the pool is retired
          and respawned (capped exponential backoff), every unfinished
          unit is re-submitted with its payload re-seeded (fresh workers
          have empty registries), and one retry is charged to the unit
          observed failing — we cannot know *which* chunk's worker died,
          so the charge is a heuristic that only shapes retry order, never
          correctness.  A unit out of retries is broken apart and its
          candidates isolated in-parent: only candidates that *keep*
          failing are quarantined, so innocents caught in a crashing
          chunk always get their (bit-identical) results.
        * **timeout**: counted on ``chunk_timeouts``, the future is
          cancelled (a no-op once running — the straggling worker keeps
          its slot and its eventual result is discarded) and the unit
          goes straight to in-parent isolation: one serial retry per
          candidate, quarantine on a second offence.
        * **in-worker exception**: an engine fault — demote once, guarded
          by the engine active at submit time so parallel same-tier
          failures demote a single step, then isolate the unit in-parent
          on the demoted tier.
        * **expired sweep deadline**: every remaining unit is cancelled
          and its candidates quarantined without evaluation.
        """
        cache_dir = self._disk.root if self._disk is not None else None
        ppool = _shared_executor(self.processes, cache_dir)
        units: "collections.deque" = collections.deque()
        n_groups = max(len(pending), 1)
        for gkey, items in pending.items():
            # a single-eligibility sweep must still use every worker: split
            # each graph key's items across the pool (deterministic slices,
            # reassembled by position)
            n_slices = max(1, min(self.processes // n_groups or 1,
                                  len(items)))
            step = -(-len(items) // n_slices)
            for lo in range(0, len(items), step):
                units.append({"gkey": gkey,
                              "ghash": self._graph_hash(gkey),
                              "items": items[lo:lo + step],
                              "tries": 0, "seed": False})
        for u in units:
            self._submit_unit(ppool, u, graph_info)
        while units:
            unit = units[0]
            if self._deadline_left() == 0.0:
                for u in units:
                    u["fut"].cancel()
                while units:
                    u = units.popleft()
                    self._isolate_candidates(graph_info[u["gkey"]][0],
                                             graph_info[u["gkey"]],
                                             u["items"], results)
                break
            try:
                got = unit["fut"].result(
                    timeout=self._unit_timeout(len(unit["items"])))
            except (FuturesTimeout, CancelledError):
                self.stats.chunk_timeouts += 1
                unit["fut"].cancel()
                units.popleft()
                self._isolate_candidates(graph_info[unit["gkey"]][0],
                                         graph_info[unit["gkey"]],
                                         unit["items"], results)
                continue
            except BrokenProcessPool:
                ppool = self._respawn_pool(ppool, units, graph_info,
                                           results)
                continue
            except Exception as exc:    # noqa: BLE001 — in-worker raise
                units.popleft()
                if unit["engine"] == self.engine:
                    try:
                        self._demote(exc)
                    except Exception:   # noqa: BLE001 — chain exhausted:
                        pass            # isolation below quarantines
                self._isolate_candidates(graph_info[unit["gkey"]][0],
                                         graph_info[unit["gkey"]],
                                         unit["items"], results)
                continue
            if got is None:
                # the worker drew a hash-only chunk before any seeding
                # chunk reached it: one re-submission with the payload
                unit["seed"] = True
                self._submit_unit(ppool, unit, graph_info)
                continue
            units.popleft()
            self._finish_unit(unit, got, graph_info, results)
        return results

    def _submit_unit(self, ppool: ProcessPoolExecutor, unit: Dict,
                     graph_info: Mapping[Tuple, Tuple]) -> None:
        """(Re-)submit one unit; records the future, the submit time and
        the engine active at submission (the demotion guard) on it."""
        payload = graph_info[unit["gkey"]][0]
        orders_arg = None
        if self.batch:
            # ship the sweep's known orders for this graph so worker
            # chunks replay warm (the workers' own registry persists
            # across chunks too; discoveries ride back on the result)
            self._load_orders(payload)
            orders_arg = self.order_library.export(
                payload.content_hash(), self.policy) or None
        ghash = unit["ghash"]
        fg_arg = None
        if unit["seed"] or (self._disk is None and
                            self._shipped.get(ghash, 0) < self.processes):
            # no disk store to self-serve from: seed the first `processes`
            # slices with the payload so every worker (whichever slices it
            # draws) is likely covered.  Retries always re-ship it — a
            # respawned pool's workers have empty registries, and the disk
            # entry may be the very thing that is corrupt
            fg_arg = payload
            self._shipped[ghash] = self._shipped.get(ghash, 0) + 1
        work = [(pos, cand.system) for pos, cand, _, _, _ in unit["items"]]
        prune_arg = None
        if self.batch and (self._incumbent is not None
                           or self._prune_energy_cap is not None):
            # ship the parent's best-so-far at submit time; the worker
            # re-seeds a local incumbent with it (sound: its cutoff only
            # ever over-estimates the final global k-th best) and folds
            # improvements back through the stats dict
            fam = [cand for _, cand, _, _, _ in unit["items"]]
            prune_arg = (
                self._incumbent.get() if self._incumbent is not None
                else float("inf"),
                self._incumbent.k if self._incumbent is not None else 0,
                self._family_caps(fam))
        unit["engine"] = self.engine
        unit["t0"] = time.perf_counter()
        unit["fut"] = ppool.submit(_process_eval_chunk, ghash, fg_arg, work,
                                   self.policy, self.batch, orders_arg,
                                   self.max_rescue_rounds, prune_arg)

    def _respawn_pool(self, ppool: ProcessPoolExecutor,
                      units: "collections.deque",
                      graph_info: Mapping[Tuple, Tuple],
                      results: List) -> ProcessPoolExecutor:
        """Replace a broken pool: retire it, back off, spawn a fresh one,
        and re-submit every unfinished unit (their futures died with the
        pool).  One retry is charged to ``units[0]`` — the unit whose
        result surfaced the break; out of retries it is isolated
        in-parent instead of re-submitted."""
        self.stats.pool_respawns += 1
        self._respawns += 1
        _retire_executor(ppool)
        self._shipped = {}          # fresh workers: re-seed payloads
        time.sleep(min(BACKOFF_CAP_S,
                       BACKOFF_BASE_S * 2 ** (self._respawns - 1)))
        ppool = _shared_executor(
            self.processes,
            self._disk.root if self._disk is not None else None)
        unit = units[0]
        unit["tries"] += 1
        if unit["tries"] > self.max_retries:
            units.popleft()
            self._isolate_candidates(graph_info[unit["gkey"]][0],
                                     graph_info[unit["gkey"]],
                                     unit["items"], results)
        for u in units:
            f = u.get("fut")
            if f is not None and not f.cancelled() and f.done() \
                    and f.exception() is None:
                continue        # completed before the break: result intact
            self.stats.worker_retries += 1
            u["seed"] = True
            self._submit_unit(ppool, u, graph_info)
        return ppool

    def _finish_unit(self, unit: Dict, got: Tuple,
                     graph_info: Mapping[Tuple, Tuple],
                     results: List) -> None:
        pairs, worker_orders, worker_stats = got
        payload, stats, crit, lb = graph_info[unit["gkey"]]
        if worker_orders:
            # validated merge: the worker's discoveries warm this
            # sweep's library (and, with a store, tomorrow's)
            self.order_library.merge(payload, self.policy, worker_orders)
        if worker_stats:
            self.batch_stats.add_dict(worker_stats)
        sims = dict(pairs)
        share = (time.perf_counter() - unit["t0"]) \
            / max(len(unit["items"]), 1)
        for pos, cand, key, text, ghit in unit["items"]:
            sim = sims[pos]
            if not isinstance(sim, Retired):
                self._sim_store(key, text, sim)
            results[pos] = self._outcome_from_sim(
                cand, stats, crit, lb, ghit, False, sim, share)

    def _evaluate_megabatch(self, pending: Mapping[Tuple, Sequence[Tuple]],
                            graph_info: Mapping[Tuple, Tuple],
                            results: List) -> List:
        """Every graph family of one evaluation chunk through a single
        lane axis (:func:`repro_torch.core.torchsim.simulate_torch_many`):
        the torch engine's only lane path."""
        from .torchsim import simulate_torch_many
        gkeys = list(pending)
        fams = []
        prunes: List[Optional[PruneContext]] = []
        for gkey in gkeys:
            payload = graph_info[gkey][0]
            self._load_orders(payload)
            fam = [cand for _, cand, _, _, _ in pending[gkey]]
            fams.append((payload, [c.system for c in fam]))
            # one context per family, all sharing the live incumbent —
            # cross-family tightening happens inside the megabatch too
            prunes.append(self._family_prune(fam))
        t0 = time.perf_counter()
        kw = {} if self.torch_chunk is None else {"chunk": self.torch_chunk}
        fam_sims = simulate_torch_many(
            fams, self.policy, device=self.device, stats=self.batch_stats,
            library=self.order_library, max_rounds=self.max_rescue_rounds,
            prunes=prunes if any(p is not None for p in prunes) else None,
            compile_cache=self.compile_cache, **kw)
        n_total = sum(len(v) for v in pending.values()) or 1
        share = (time.perf_counter() - t0) / n_total
        with tracing.span("sweep.assemble"):
            for gkey, sims in zip(gkeys, fam_sims):
                _, stats, crit, lb = graph_info[gkey]
                for (pos, cand, key, text, ghit), sim in zip(pending[gkey],
                                                             sims):
                    if not isinstance(sim, Retired):
                        self._sim_store(key, text, sim)
                    results[pos] = self._outcome_from_sim(
                        cand, stats, crit, lb, ghit, False, sim, share)
        return results

    def _family_caps(self, cands: Sequence[Candidate]) \
            -> Optional[List[float]]:
        """Static per-lane energy caps for one candidate family —
        ``energy_cap / static_w`` per lane (energy >= static_w × makespan
        >= static_w × bound, so a bound past the cap proves
        infeasibility); ``None`` when no energy budget is armed."""
        if self._prune_energy_cap is None:
            return None
        caps = []
        for c in cands:
            w = self.hwspec.annotate(c.system, 0.0, {}).static_w
            caps.append(self._prune_energy_cap / w if w > 0
                        else float("inf"))
        return caps

    def _family_prune(self, cands: Sequence[Candidate]) \
            -> Optional[PruneContext]:
        """The :class:`~repro_torch.core.replay.PruneContext` for one family of
        the current explore call: the live shared incumbent, the static
        energy caps, and the engine's equivalence tolerance (torch inflates
        the cutoff by its rtol so a sub-tolerance tie can never retire
        off the exact top-k).  ``None`` when nothing can retire."""
        caps = self._family_caps(cands)
        if self._incumbent is None and caps is None:
            return None
        return PruneContext(self._incumbent, caps,
                            ENGINE_TOLERANCE.get(self.engine, 0.0))

    def _lockstep_family(self, payload: FrozenGraph,
                         cands: Sequence[Candidate],
                         prune: Optional[PruneContext] = None) \
            -> List[Union[SimResult, Retired]]:
        """One graph-sharing candidate family through the configured exact
        engine (the numpy lockstep backend, ``fast`` or the reference),
        replaying orders from the sweep's (disk-warmed) library.  The torch
        engine never comes here: its families go through
        :meth:`_evaluate_megabatch`, and after a fault it is ``batch``.
        With ``prune``, lanes may come back as
        :class:`~repro_torch.core.replay.Retired` markers (the
        ``family_runner`` seam stays unpruned in-flight — its sweeps run
        out-of-process of the incumbent; the pre-cut in ``_explore`` still
        applies to its candidates).

        An engine fault demotes down :data:`~repro_torch.core.replay.
        ENGINE_FALLBACK` and re-runs the *whole family* on the next tier
        (results so far are per-family, so nothing partial leaks); only an
        exhausted chain lets the exception out to the caller's isolation
        path.  On the card the fault re-raises instead
        (:meth:`_engine_fault`)."""
        systems = [c.system for c in cands]
        while True:
            try:
                if self.engine == "batch":
                    self._load_orders(payload)
                    if self.family_runner is not None:
                        return self.family_runner(payload, systems,
                                                  self._deadline_left())
                    return simulate_batch(payload, systems, self.policy,
                                          stats=self.batch_stats,
                                          library=self.order_library,
                                          max_rounds=self.max_rescue_rounds,
                                          prune=prune)
                if self.engine == "fast":
                    return [simulate_fast(payload, s, self.policy)
                            for s in systems]
                return [self._reference_sim(c) for c in cands]
            except FuturesTimeout:
                # a missed deadline out of the family runner is not an
                # engine fault: let the caller's isolation path quarantine
                # (or rescue) per candidate without burning a demotion
                raise
            except Exception as exc:    # noqa: BLE001 — engine fault
                self._engine_fault(exc)     # raises on the card or when
                #                             the chain is exhausted

    def _materialise_schedules(self, result: ExplorationResult,
                               cands: Sequence[Candidate],
                               estimates: Dict[str, PerfEstimate],
                               kk: int) -> None:
        """Fast mode ranks on schedule-free sims; rebuild the full
        ScheduledTask records for the top-k winners only."""
        if not self.fast or not estimates:
            return
        by_name = {c.name: c for c in cands}
        for o in result.ranked[:kk]:
            est = estimates.get(o.name)
            if est is None or est.sim.schedule:
                continue
            est.sim = self._full_schedule_sim(by_name[o.name])

    # ------------------------------------------------------------------
    def hillclimb(self, space: DesignSpace,
                  build: Callable[[Mapping[str, Any]], Candidate],
                  start: Optional[Mapping[str, Any]] = None,
                  max_evals: int = 200, seed: int = 0):
        """Local search over ``space``; infeasible fabrics score ``inf``.

        Returns ``(best_point, best_makespan_s, history)``.
        """
        def score(point: Mapping[str, Any]) -> float:
            cand = build(point)
            if cand.fabric and not cand.feasible(self.budget):
                return float("inf")
            est, _ = self._evaluate_outcome(cand)
            return float("inf") if est is None else est.makespan_s

        return hillclimb(space, score, start=start, max_evals=max_evals,
                         seed=seed)


# ---------------------------------------------------------------------------
# Seed-compatible front-end
# ---------------------------------------------------------------------------


def explore(trace: Trace, candidates: Sequence[Candidate], reports: ReportMap,
            policy: str = "availability", smp_scale: float = 1.0,
            smp_seconds_fn=None,
            budget: Mapping[str, float] = ZYNQ_7045_BUDGET, *,
            max_workers: Optional[int] = None, cache: bool = True,
            prune: bool = False, top_k: Optional[int] = None,
            fast: bool = True, batch: Optional[bool] = None,
            processes: int = 0,
            cache_dir: Optional[str] = None,
            engine: Optional[str] = None,
            device: Optional[str] = None,
            torch_chunk: Optional[int] = None,
            order_library: Optional[ReplayLibrary] = None,
            max_rescue_rounds: int = MAX_RESCUE_ROUNDS,
            objectives: Optional[Sequence[str]] = None,
            budgets: Optional[Union[Budgets, Mapping[str, float]]] = None,
            hwspec: Optional[SpecLibrary] = None) -> ExplorationResult:
    """Estimate every feasible candidate; rank; pick the best.

    This is the "coffee-break" loop: its wall time replaces one bitstream
    generation *per candidate* in the traditional flow.  The seed signature
    is unchanged; the keyword-only knobs expose the engine (worker/process
    count, in-memory + on-disk caching, lower-bound pruning, top-k
    ranking, compiled vs reference simulation engine).
    """
    ex = Explorer(trace, reports, policy=policy, smp_scale=smp_scale,
                  smp_seconds_fn=smp_seconds_fn, budget=budget,
                  max_workers=max_workers, cache=cache, fast=fast,
                  batch=batch, processes=processes, cache_dir=cache_dir,
                  engine=engine, device=device, torch_chunk=torch_chunk,
                  order_library=order_library,
                  max_rescue_rounds=max_rescue_rounds,
                  objectives=objectives, budgets=budgets, hwspec=hwspec)
    return ex.explore(candidates, top_k=top_k, prune=prune)
