"""Heterogeneous dataflow simulator — the paper's §IV engine.

Event-driven list scheduling over the augmented task graph, reproducing the
Nanos++ runtime behaviour: a task becomes *ready* when all its dependences
are satisfied; the scheduler then commits it to a device pool; it starts when
a slot of that pool frees up (FIFO per pool).

Policies
--------
* ``availability`` — the runtime behaviour the paper models and analyses:
  take whichever compatible device can *start* the task earliest, preferring
  an accelerator on ties.  This faithfully reproduces the paper's observed
  pathology (Fig. 5/7): with ``device(fpga,smp)`` a free-but-slow SMP core
  grabs tasks whose FPGA version is 30× faster → load imbalance.
* ``eft`` — earliest-finish-time (start + cost): the "smarter" scheduler the
  paper hints at in future work; used by the framework-level estimator.

Placement of a compute task is decided once, the first time any task of its
unit (input submits / itself) becomes ready — matching the runtime, which
picks the device at dispatch and then runs the device-specific prologue
(DMA programming, input transfer) for that choice.  Augmentation tasks carry
``conditional_on``: when the compute task landed on the SMP they are
zero-cost and occupy nothing (no DMA happens for SMP execution).

The engine optionally takes a ``time_model`` hook that perturbs each task's
base cost — the *reference executor* uses it to inject the fine-grain
effects the coarse estimator deliberately ignores (memory/bus contention,
cache state, measurement noise), exactly the fidelity gap the paper reports
between its estimates and the real board.

Four engines share these semantics (see ``docs/architecture.md`` for the
decision table): this object engine (one estimate, full records,
``time_model`` hooks), :mod:`repro_torch.core.fastsim` (flat arrays, one
candidate per call — the sweep workhorse), :mod:`repro_torch.core.batchsim`
(all candidates of one frozen graph in a lockstep batch — the sweep
*throughput* engine), the first three pinned bit-identical by tests, and
:mod:`repro_torch.core.torchsim` (the lockstep jit-compiled as a ``lax.scan`` —
pinned at rtol level, ``repro_torch.core.replay.ENGINE_TOLERANCE``).  Shared
plumbing lives here: :func:`validate_pools` (the degenerate-candidate
guard every engine runs before touching pool state) and
:meth:`SimResult.without_schedule` (the schedule-free projection batch
ranking stores, with full records replayed only for top-k winners).
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .devices import DevicePool, SharedResource, SystemConfig
from .taskgraph import Task, TaskGraph

TimeModel = Callable[[Task, str, float, float], float]
# (task, device kind, base cost, start time) -> actual cost


def validate_pools(system: "SystemConfig") -> None:
    """Reject degenerate pool layouts before any engine touches them.

    A 0-slot pool used to surface deep inside the event loop as an opaque
    ``IndexError``/``ValueError`` (empty slot-clock argmin); every engine
    (object, fast, batch) calls this up front instead so a malformed
    candidate fails with the pool and system named.
    """
    for pool in list(system.pools) + list(system.shared):
        count = int(pool.count)
        if count < 1:
            raise ValueError(
                f"pool {pool.name!r} of system {system.name!r} has "
                f"count={count}; every device pool / shared resource needs "
                f"at least one slot (drop the pool from the candidate "
                f"instead of zeroing it)")


@dataclasses.dataclass
class ScheduledTask:
    uid: int
    name: str
    pool: str
    slot: int
    kind: str
    start: float
    end: float
    role: str


@dataclasses.dataclass
class SimResult:
    makespan: float
    schedule: List[ScheduledTask]
    busy: Dict[str, float]                 # per pool, summed busy seconds
    pool_slots: Dict[str, int]
    placements: Dict[int, str]             # compute task uid -> device kind
    policy: str
    system: str

    def utilization(self) -> Dict[str, float]:
        if self.makespan <= 0:
            return {p: 0.0 for p in self.busy}
        return {p: self.busy[p] / (self.makespan * self.pool_slots[p])
                for p in self.busy}

    def bottleneck(self) -> str:
        util = self.utilization()
        return max(util, key=lambda p: util[p]) if util else ""

    def without_schedule(self) -> "SimResult":
        """Schedule-free projection of this result (records dropped).

        The exploration engines rank on exactly this shape; full
        :class:`ScheduledTask` records are replayed (``simulate_fast``,
        ``with_schedule=True``) only for top-k winners.  Everything a
        ranking consumes — makespan, busy sums, placements, utilization —
        is preserved, so ``without_schedule()`` of a full run compares
        equal to a schedule-free run of the same candidate.
        """
        return dataclasses.replace(self, schedule=[])

    def per_kind_task_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        if self.schedule:
            for s in self.schedule:
                if s.role == "compute":
                    out[s.kind] += 1
        else:
            # schedule-free fast mode: placements holds exactly the compute
            # tasks, so the counts are recoverable without the records
            for kind in self.placements.values():
                out[kind] += 1
        return dict(out)

    def summary(self) -> Dict[str, object]:
        return {
            "system": self.system, "policy": self.policy,
            "makespan_s": self.makespan,
            "utilization": {k: round(v, 4) for k, v in self.utilization().items()},
            "bottleneck": self.bottleneck(),
            "compute_placement_counts": self.per_kind_task_counts(),
        }


class _Pool:
    """Runtime state of a device pool: one monotone clock per slot."""

    def __init__(self, name: str, kinds: Tuple[str, ...], count: int):
        self.name = name
        self.kinds = kinds
        self.count = count
        self.slot_clock = [0.0] * count

    def earliest_slot(self) -> Tuple[float, int]:
        # Most dispatches land on 1-slot pools (submit, dma_out): answer
        # without scanning at all.  Larger pools argmin via min()+index() —
        # both scans run at C speed, which beats a single Python-level pass
        # at every pool size (measured: ≥4× at 100 slots, break-even at 2).
        clocks = self.slot_clock
        if len(clocks) == 1:
            return clocks[0], 0
        t = min(clocks)
        return t, clocks.index(t)

    def commit(self, ready_t: float, cost: float) -> Tuple[float, float, int]:
        t, i = self.earliest_slot()
        start = max(ready_t, t)
        end = start + cost
        self.slot_clock[i] = end
        return start, end, i


class Simulator:
    def __init__(self, graph: TaskGraph, system: SystemConfig,
                 policy: str = "availability",
                 time_model: Optional[TimeModel] = None):
        if policy not in ("availability", "eft"):
            raise ValueError(f"unknown policy {policy!r}")
        validate_pools(system)
        self.graph = graph
        self.system = system
        self.policy = policy
        self.time_model = time_model
        self.pools: Dict[str, _Pool] = {}
        for p in system.pools:
            self.pools[p.name] = _Pool(p.name, p.kinds, p.count)
        for r in system.shared:
            self.pools[r.name] = _Pool(r.name, (r.name,), r.count)
        self._kind_to_pool: Dict[str, str] = {}
        for pool in self.pools.values():
            for k in pool.kinds:
                self._kind_to_pool.setdefault(k, pool.name)

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        g = self.graph
        n_pred: Dict[int, int] = {u: len(g.pred.get(u, ())) for u in g.tasks}
        ready_time: Dict[int, float] = {u: 0.0 for u in g.tasks}
        placements: Dict[int, str] = {}
        schedule: List[ScheduledTask] = []
        busy: Dict[str, float] = defaultdict(float)

        heap: List[Tuple[float, int, int]] = []  # (ready_t, creation_idx, uid)
        for u, d in n_pred.items():
            if d == 0:
                t = g.tasks[u]
                heapq.heappush(heap, (0.0, t.creation_index, u))

        makespan = 0.0
        done = 0
        while heap:
            rt, _, uid = heapq.heappop(heap)
            task = g.tasks[uid]
            end = self._dispatch(task, rt, placements, schedule, busy)
            makespan = max(makespan, end)
            done += 1
            for v in g.succ.get(uid, ()):
                ready_time[v] = max(ready_time[v], end)
                n_pred[v] -= 1
                if n_pred[v] == 0:
                    heapq.heappush(heap, (ready_time[v],
                                          g.tasks[v].creation_index, v))
        if done != len(g.tasks):
            raise RuntimeError(f"deadlock: executed {done}/{len(g.tasks)} tasks")
        return SimResult(
            makespan=makespan, schedule=schedule, busy=dict(busy),
            pool_slots={p.name: p.count for p in self.pools.values()},
            placements=placements, policy=self.policy, system=self.system.name)

    # ------------------------------------------------------------------
    def _dispatch(self, task: Task, ready_t: float, placements: Dict[int, str],
                  schedule: List[ScheduledTask], busy: Dict[str, float]) -> float:
        role = task.role
        cond = task.meta.get("conditional_on")
        if cond is not None:
            parent_kind = placements.get(int(cond))
            if parent_kind is None:
                # first unit member to wake — decide the compute placement now
                parent = self.graph.tasks[int(cond)]
                parent_kind = self._choose_kind(parent, ready_t)
                placements[int(cond)] = parent_kind
            if parent_kind not in tuple(task.meta.get("active_kinds", ())):
                # compute task went to the SMP → no DMA: zero-cost pass-through
                schedule.append(ScheduledTask(task.uid, task.name, "-", 0,
                                              "skipped", ready_t, ready_t, role))
                return ready_t

        if role == "compute":
            kind = placements.get(task.uid) or self._choose_kind(task, ready_t)
            placements[task.uid] = kind
        else:
            kind = task.devices[0]

        pool = self.pools[self._kind_to_pool[kind]]
        base = task.cost_on(kind)
        start_est, _ = pool.earliest_slot()
        start = max(ready_t, start_est)
        cost = base if self.time_model is None else \
            self.time_model(task, kind, base, start)
        start, end, slot = pool.commit(ready_t, cost)
        busy[pool.name] += end - start
        schedule.append(ScheduledTask(task.uid, task.name, pool.name, slot,
                                      kind, start, end, role))
        return end

    def _choose_kind(self, task: Task, ready_t: float) -> str:
        """Scheduling policy: device kind for a compute task."""
        options: List[Tuple[float, float, int, str]] = []
        for idx, kind in enumerate(task.devices):
            pool_name = self._kind_to_pool.get(kind)
            if pool_name is None:
                continue
            pool = self.pools[pool_name]
            slot_t, _ = pool.earliest_slot()
            start = max(ready_t, slot_t)
            cost = task.cost_on(kind)
            accel_pref = 1 if kind == "smp" else 0  # prefer accel on ties
            if self.policy == "availability":
                options.append((start, accel_pref, idx, kind))
            else:  # eft
                options.append((start + cost, accel_pref, idx, kind))
        if not options:
            raise RuntimeError(f"task {task.name}#{task.uid}: no compatible pool "
                               f"among kinds {task.devices}")
        options.sort()
        return options[0][3]


def simulate(graph: TaskGraph, system: SystemConfig,
             policy: str = "availability",
             time_model: Optional[TimeModel] = None) -> SimResult:
    return Simulator(graph, system, policy, time_model).run()
